"""Shiny UI widgets for the web apps: clickable image galleries, the
server-side file browser, the Google-Analytics inject and the client URL
query parameters.

A copy of ``helicon_tpu/utils/shiny.py`` (host code; reference
lib/shiny.py, 611 LoC). Requires the optional ``shiny`` extra: every
widget degrades to a clear dependency error without it.
tests/test_torch_webapp_apps.py pins the copy to the original.
"""

from __future__ import annotations

from ..utils.exceptions import HeliconDependencyError
from .system import encode_numpy, has_shiny

__all__ = [
    "file_selection_server",
    "file_selection_ui",
    "get_client_url",
    "get_client_url_query_params",
    "google_analytics",
    "image_gallery",
    "image_select",
    "int_or",
    "numeric_or",
    "server_file_browser",
    "set_client_url_query_params",
]


def numeric_or(value, default=0.0) -> float:
    """Shiny numeric-input value -> float; a CLEARED field returns None
    (float(None) inside a reactive effect kills the whole session)."""
    return default if value is None else float(value)


def int_or(value, default=0) -> int:
    """Shiny numeric-input value -> int; None (cleared field) -> default."""
    return default if value is None else int(value)


def _require_shiny():
    if not has_shiny():
        raise HeliconDependencyError(
            "this widget requires the optional 'shiny' extra"
        )


def image_select(
    id: str,
    label: str,
    images,
    image_labels=(),
    image_size: int = 128,
    initial_selected_indices=(),
    enable_selection: bool = True,
):
    """Clickable image-selection grid (lib/shiny.py:24-200).

    initial_selected_indices: indices rendered with a highlight border —
    the caller re-renders the grid when its selection changes, so this
    IS the live selection state."""
    _require_shiny()
    from shiny import ui

    selected = set(initial_selected_indices or ())
    tags = []
    for i, img in enumerate(images):
        src = img if isinstance(img, str) else encode_numpy(img)
        lbl = image_labels[i] if i < len(image_labels) else str(i + 1)
        border = (
            "outline: 3px solid #e4572e; outline-offset: -3px;"
            if i in selected
            else ""
        )
        tags.append(
            ui.tags.figure(
                ui.tags.img(
                    src=src,
                    width=f"{image_size}px",
                    style=("cursor: pointer;" if enable_selection else "")
                    + border,
                    onclick=(
                        f"Shiny.setInputValue('{id}', {i}, "
                        "{priority: 'event'});"
                        if enable_selection
                        else ""
                    ),
                ),
                ui.tags.figcaption(lbl, style="text-align: center;"),
                style="display: inline-block; margin: 2px;",
            )
        )
    return ui.div(ui.tags.label(label), ui.div(*tags), id=f"{id}_container")


def image_gallery(
    id: str, label: str, images, image_labels=(), image_size: int = 128, **kwargs
):
    """Non-interactive image grid (lib/shiny.py:200-342)."""
    return image_select(
        id, label, images, image_labels, image_size, enable_selection=False
    )


def server_file_browser(id: str, label: str = "Select file", root: str = "."):
    """Server-side file browser widget (lib/shiny.py:343-523)."""
    _require_shiny()
    from pathlib import Path

    from shiny import ui

    entries = sorted(Path(root).glob("*"))
    return ui.input_select(
        id, label, choices=[str(e) for e in entries], selected=None
    )


def google_analytics(tag_id: str):
    """GA script tag (lib/shiny.py:524-541)."""
    _require_shiny()
    from shiny import ui

    return ui.tags.head(
        ui.tags.script(
            src=f"https://www.googletagmanager.com/gtag/js?id={tag_id}",
            **{"async": ""},
        ),
        ui.tags.script(
            f"window.dataLayer = window.dataLayer || [];"
            f"function gtag(){{dataLayer.push(arguments);}}"
            f"gtag('js', new Date()); gtag('config', '{tag_id}');"
        ),
    )


def get_client_url_query_params(input, keep_list: bool = True):
    """Parse the client URL query string from the Shiny input object
    (reference lib/shiny.py:542-575). keep_list=False unwraps
    single-element lists."""
    from urllib.parse import parse_qs

    # the reference reads through input._map (lib/shiny.py:576-577) —
    # downstream code/tests stub that attribute, so try it first
    imap = getattr(input, "_map", None)
    if isinstance(imap, dict) and ".clientdata_url_search" in imap:
        search = imap[".clientdata_url_search"]()
    else:
        try:
            search = input[".clientdata_url_search"]()
        except (TypeError, KeyError):
            # a session was passed instead of its input object
            search = input.input[".clientdata_url_search"]()
    d = parse_qs(str(search).lstrip("?"))
    if not keep_list:
        d = {k: (v[0] if len(v) == 1 else v) for k, v in d.items()}
    return d


def set_client_url_query_params(query_params: dict):
    """Script tag that pushes query params into the client URL
    (reference lib/shiny.py:576-611). Returns a shiny ui.tags.script
    when shiny is installed, else the raw <script> string."""
    from urllib.parse import urlencode

    q = urlencode(query_params, doseq=True)
    js = f"""
    var url = new URL(window.location.href);
    url.search = "{q}";
    history.replaceState(null, "", url.toString());
    """
    try:
        from shiny import ui

        return ui.tags.script(js)
    except ImportError:
        return f"<script>{js}</script>"


def get_client_url(input):
    """Full client URL reconstructed from Shiny clientdata (reference
    lib/shiny.py:542-557)."""
    d = input._map
    return (
        f"{d['.clientdata_url_protocol']()}//"
        f"{d['.clientdata_url_hostname']()}:{d['.clientdata_url_port']()}"
        f"{d['.clientdata_url_pathname']()}{d['.clientdata_url_search']()}"
    )


def file_selection_ui(label="Select a file", value=None, width="100%"):
    """Browse-popover file selector UI (reference lib/shiny.py:343-397):
    a Browse popover holding the current directory, a sub-directory
    navigator, and a file picker, next to the editable path field."""
    _require_shiny()
    from pathlib import Path

    from shiny import ui

    start_dir = str(Path(value).parent) if value else str(Path.cwd())
    return ui.div(
        ui.popover(
            ui.input_action_button(
                "file_selection_browse", "Browse",
                style="height: 30px; --bs-btn-padding-y: 0",
            ),
            ui.input_text(
                "file_selection_dir", "Current directory",
                value=start_dir, width="100%",
            ),
            ui.layout_column_wrap(
                ui.input_select(
                    "file_selection_subdir", "Go to a sub-directory",
                    choices=[], width="100%",
                ),
                ui.input_select(
                    "file_selection_file", "Select a file",
                    choices=[Path(value).name] if value else [],
                    selected=Path(value).name if value else None,
                    width="100%",
                ),
                width="100%",
            ),
            title=label,
            width="100%",
        ),
        ui.input_text(
            "file_selection_path", label, value=value or "", width=width
        ),
        style=(
            "display: flex; flex-flow: row; align-items: stretch; "
            f"gap: 2px; margin: 0; padding: 0; width: {width};"
        ),
    )


def file_selection_server(
    input, output, session, file_types=None, ignore_hidden_files=True
):
    """Server half of the file selector (reference lib/shiny.py:398-523):
    wires the popover's directory/file navigation and returns a reactive
    calc yielding the validated selected path."""
    _require_shiny()
    from pathlib import Path

    from shiny import reactive, req, ui

    if file_types and isinstance(file_types, str):
        file_types = [file_types]

    def _visible(entries):
        return [
            e for e in entries if not (ignore_hidden_files and e.startswith("."))
        ]

    @reactive.effect
    @reactive.event(input.file_selection_dir)
    def _update_listing():
        p = Path(input.file_selection_dir())
        req(p.is_dir())
        try:
            names = sorted(e.name for e in p.iterdir())
        except OSError:
            ui.modal_show(
                ui.modal(
                    f"{p}: failed to list the directory.",
                    title="Folder access error", easy_close=True, footer=None,
                )
            )
            return
        dirs = _visible([n for n in names if (p / n).is_dir()])
        files = _visible([n for n in names if (p / n).is_file()])
        if file_types:
            files = [f for f in files if any(f.endswith(t) for t in file_types)]
        ui.update_select(
            "file_selection_subdir", choices=[".", ".."] + dirs, selected="."
        )
        cur = Path(input.file_selection_path() or "")
        keep = cur.name if cur.parent == p and cur.name in files else None
        ui.update_select(
            "file_selection_file", choices=files,
            selected=keep or (files[0] if files else None),
        )

    @reactive.effect
    @reactive.event(input.file_selection_subdir)
    def _navigate():
        sub = input.file_selection_subdir()
        req(sub and sub != ".")
        target = (Path(input.file_selection_dir()) / sub).resolve()
        if target.is_dir():
            ui.update_text("file_selection_dir", value=str(target))

    @reactive.effect
    @reactive.event(input.file_selection_file)
    def _pick():
        f = input.file_selection_file()
        req(f)
        ui.update_text(
            "file_selection_path",
            value=str(Path(input.file_selection_dir()) / f),
        )

    @reactive.calc
    def selected_file():
        path = input.file_selection_path()
        if not path:
            return None
        if file_types and not any(str(path).endswith(t) for t in file_types):
            return None
        p = Path(path)
        if ignore_hidden_files and p.name.startswith("."):
            return None
        return p if p.exists() else None

    return selected_file
