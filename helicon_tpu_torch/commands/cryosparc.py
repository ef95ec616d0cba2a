"""A command line tool that works with CryoSPARC .cs files / server jobs

Loads particles/exposures from local .cs files (with automatic
passthrough merging), applies the CLI-ordered exposure-group/extraction
pipeline, and saves the result as a local .cs file.

Counterpart of ``helicon_tpu/commands/cryosparc.py``, with ``--device``
(default ``cuda``, the card): --extractParticles cuts, crops and
normalises its boxes there; the other options are host pandas. Server-job
IO (projectID/jobID) requires cryosparc-tools and raises
HeliconDependencyError without it; local-file mode is fully supported.
tests/test_torch_cryosparc.py pins the port to the original.

  helicon-torch cryosparc --csFile J1_particles.cs --extractParticles box_size=384:fft_crop_size=128 --device cpu
"""

from __future__ import annotations

import argparse
import logging
import sys
from pathlib import Path

import numpy as np
import pandas as pd

from ..utils.exceptions import HeliconError

logger = logging.getLogger(__name__)


def main(args: argparse.Namespace) -> None:
    from ..io.cs import read_cs
    from ..io.metadata import dataframe2cs
    from ..ops.cryosparc import dispatch
    from ..utils.collections import first_matched_attr
    from ..utils.logging import log_command_line
    from . import command_device

    log_command_line()
    command_device(getattr(args, "device", "cuda"))
    logging.basicConfig(
        level=(
            logging.DEBUG
            if args.verbose > 2
            else logging.INFO if args.verbose > 0 else logging.ERROR
        ),
        format="%(message)s",
        stream=sys.stdout,
    )

    server = None
    if args.csFile:
        frames = []
        input_types = []
        from ..io.cs import find_passthrough_file

        for f in args.csFile:
            cs = read_cs(f)
            df = pd.DataFrame.from_records(cs.tolist(), columns=cs.dtype.names)
            is_particle = "blob/path" in df
            # match the passthrough KIND to this input's type — an
            # exposures input must not adopt a particles passthrough
            prefer = (
                ("particles", "exposures")
                if is_particle
                else ("exposures", "particles")
            )
            pt, warn = find_passthrough_file(f, prefer=prefer)
            if pt is not None and warn:
                logger.warning(
                    "using passthrough %s for %s — not from the same "
                    "job; place the matching J*_passthrough_*.cs next "
                    "to the input to override",
                    pt.name, f,
                )
            if pt is not None:
                p = read_cs(pt)
                pdf = pd.DataFrame.from_records(p.tolist(), columns=p.dtype.names)
                add = [c for c in pdf.columns if c not in df.columns or c == "uid"]
                if "uid" in pdf and "uid" in df:
                    df = df.merge(pdf[add], on="uid", how="left")
            # .cs |S fields arrive as bytes; every downstream consumer
            # (path building, regexes, the .cs writer's str().encode())
            # expects str — decode like io.metadata.cs2dataframe does
            for c in df.columns:
                if df[c].dtype == object and len(df):
                    # the left-merge above can leave NaN in row 0 for uids
                    # missing from the passthrough — detect bytes on the
                    # first NON-NULL value, not blindly on iloc[0]
                    nonnull = df[c].dropna()
                    if len(nonnull) and isinstance(nonnull.iloc[0], bytes):
                        df[c] = df[c].str.decode("utf-8", errors="replace")
            frames.append(df)
            input_types.append("particle" if is_particle else "exposure")
    else:
        # live-server mode (reference cryosparc.py:78-96): connect, pull
        # each job's output group; gated on cryosparc-tools
        try:
            import cryosparc.tools  # noqa: F401
        except ImportError as e:
            from ..utils.exceptions import HeliconDependencyError

            raise HeliconDependencyError(
                "CryoSPARC server mode (--projectID/--jobID) requires the "
                "cryosparc-tools package; provide local --csFile inputs "
                "instead"
            ) from e
        from ..io.metadata import connect_cryosparc

        cs_client = connect_cryosparc()
        project = cs_client.find_project(args.projectID)
        frames = []
        input_types = []
        used_jobs = []  # (jobID, groupIndex) actually ingested — the
        # write-back must connect exactly these, not skipped jobs
        for i, jobID in enumerate(args.jobID):
            input_job = cs_client.find_job(args.projectID, jobID)
            groups = input_job.doc["output_result_groups"]
            if len(groups) < 1:
                logger.warning("%s has no output groups. Ignored", jobID)
                continue
            gidx = args.groupIndex[i] if i < len(args.groupIndex) else 0
            group = groups[gidx]
            ds = input_job.load_output(group["name"])
            frames.append(_dataset_to_dataframe(ds))
            input_types.append(group["type"])
            used_jobs.append((jobID, gidx))
            if args.outputWorkspaceID is None:
                args.outputWorkspaceID = input_job.doc["workspace_uids"][-1]
        if not frames:
            raise HeliconError("no input data")
        server = (cs_client, project, used_jobs)
    if len(set(input_types)) > 1:
        raise HeliconError(f"mixed input types: {input_types}")
    input_type = input_types[0]
    data = pd.concat(frames, ignore_index=True) if len(frames) > 1 else frames[0]
    if not len(data):
        raise HeliconError("no data in the input")
    data.attrs["convention"] = "cryosparc"

    attrs = (
        "movie_blob/path micrograph_blob/path location/micrograph_path blob/path"
    ).split()
    micrograph_name = first_matched_attr(data, attrs=attrs)
    if micrograph_name is None:
        raise HeliconError(f"one of {attrs} must be available")

    from ..utils.collections import all_matched_attrs

    exp_group_id_name = first_matched_attr(
        data,
        attrs="ctf/exp_group_id location/exp_group_id mscope_params/exp_group_id".split(),
    )
    if exp_group_id_name is None:
        exp_group_id_name = "mscope_params/exp_group_id"
        data[exp_group_id_name] = np.uint32(1)
    original_exp_group_ids = np.unique(data[exp_group_id_name])

    output_title = ""
    output_slots = set()
    index_d = {o: 0 for o in args.all_options}
    for option_name in args.all_options:
        if option_name in args.append_options:
            # unlike the images2star/proc3d families (whose plugins bump
            # index_d themselves), cryosparc handlers never touch
            # index_d — the loop advances repeated options, exactly as
            # the reference does (reference cryosparc.py:166-167)
            param = args.__dict__[option_name][index_d[option_name]]
            index_d[option_name] += 1
        else:
            param = args.__dict__[option_name]
        if args.verbose:
            logger.info("%s: %s", option_name, param)
        data, output_title, output_slots, index_d = dispatch(
            option_name, data, args, index_d, param, output_title, output_slots,
            exp_group_id_name, micrograph_name, original_exp_group_ids,
        )

    if server is not None and not args.saveLocal:
        _save_to_server(
            server, args, data, input_type, output_slots, output_title
        )
        if args.verbose:
            logger.info(
                "%d rows uploaded to %s/%s (%s)",
                len(data), args.projectID, args.outputWorkspaceID, output_title,
            )
        return
    out = args.output_csFile or (
        (Path(args.csFile[0]).stem if args.csFile else
         f"{args.projectID}_{'-'.join(args.jobID)}") + ".helicon.cs"
    )
    dataframe2cs(data, out)
    if args.verbose:
        logger.info("%d rows saved to %s (%s)", len(data), out, output_title)


def _dataset_to_dataframe(ds) -> pd.DataFrame:
    """cryosparc Dataset (or structured array) -> DataFrame, one column
    per field; fixed-length subarray fields stay as object columns."""
    if isinstance(ds, np.ndarray) and ds.dtype.names:
        names = ds.dtype.names
        get = lambda n: ds[n]
    else:  # cryosparc.dataset.Dataset duck type
        names = [f for f in ds.fields() if f]
        get = lambda n: np.asarray(ds[n])
    cols = {}
    for n in names:
        v = np.asarray(get(n))
        if v.dtype.kind == "S":  # |S bytes -> str for path/regex consumers
            # errors="replace" like the local --csFile decode path: a
            # malformed byte must not abort server-mode ingestion
            v = np.char.decode(v, "utf-8", errors="replace")
        cols[n] = list(v) if v.ndim > 1 else v
    df = pd.DataFrame(cols)
    df.attrs["convention"] = "cryosparc"
    return df


def _save_to_server(server, args, data, input_type, output_slots, output_title):
    """Write results back as a CryoSPARC external job (the reference's
    extractParticles pattern, extractparticles.py:266-302, 453,
    generalized to the whole pipeline): connect each input job's output
    group, declare an output with the touched slots, save the dataset."""
    from ..io.metadata import dataframe_to_cs_array

    cs_client, project, used_jobs = server
    target_input = "particles" if input_type == "particle" else "exposures"
    output_job = project.create_external_job(
        args.outputWorkspaceID,
        title="helicon cryosparc",
        desc=" ".join(sys.argv),
    )
    # connect only the jobs that were actually ingested — a jobID main
    # skipped (no output groups) would IndexError here
    for jobID, gidx in used_jobs:
        input_job = cs_client.find_job(args.projectID, jobID)
        group = input_job.doc["output_result_groups"][gidx]
        output_job.connect(
            target_input=target_input,
            source_job_uid=jobID,
            source_output=group["name"],
            title=target_input.capitalize(),
        )
    output_job.add_output(
        type=input_type,
        name="helicon_output",
        slots=sorted(output_slots),
        passthrough=target_input,
        title=output_title or "helicon output",
    )
    output_job.start(status="running")
    try:
        output_job.save_output("helicon_output", dataframe_to_cs_array(data))
    finally:
        output_job.stop()


def add_args(parser: argparse.ArgumentParser) -> None:
    parser.add_argument(
        "--csFile", metavar="<file.cs>", type=str, nargs="+", default=[],
        help="local CryoSPARC .cs file(s)",
    )
    parser.add_argument(
        "--output_csFile", metavar="<file.cs>", type=str, default="",
        help="output .cs file (default: <input>.helicon.cs)",
    )
    # short aliases (-p/-j/-g/-w) match the reference CLI
    # (commands/cryosparc.py:208-233); "extend" accepts both the
    # reference's repeated-flag style (-j J1 -j J2) and one-flag lists
    parser.add_argument("-p", "--projectID", metavar="<PX>", type=str, default="",
                        help="CryoSPARC project (requires cryosparc-tools)")
    parser.add_argument("-j", "--jobID", metavar="<JX>", type=str, nargs="+",
                        action="extend", default=[], help="CryoSPARC job(s)")
    parser.add_argument("-g", "--groupIndex", metavar="<n>", type=int, nargs="+",
                        action="extend", default=[],
                        help="output group index per job (default 0)")
    parser.add_argument("-w", "--outputWorkspaceID", metavar="<WX>", type=str,
                        default=None, help="output workspace (server mode)")
    parser.add_argument("--saveLocal", type=int, metavar="<0|1>", default=0,
                        help="save output as a local .cs instead of uploading")
    parser.add_argument("--verbose", type=int, metavar="<0|1|2>", default=2,
                        help="verbose level")
    parser.add_argument("--cpu", type=int, metavar="<n>", default=-1,
                        help="accepted for compatibility")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device of --extractParticles (cuda = the card; cpu)")

    from ..ops.cryosparc import add_plugin_args

    add_plugin_args(parser)
    return parser


def check_args(args, parser, argv=None):
    from ..utils.system import get_option_list

    args.append_options = [
        a.dest for a in parser._actions if type(a) is argparse._AppendAction
    ]
    all_options = get_option_list(sys.argv[1:] if argv is None else list(argv))
    # argparse (allow_abbrev) accepts unique prefixes; resolve them so
    # the execution plan carries FULL option names (an abbreviation
    # reaching dispatch() crashed mid-pipeline after data load)
    from ..utils.system import resolve_option_abbreviations

    all_options = resolve_option_abbreviations(
        all_options, [a.dest for a in parser._actions]
    )
    skip = (
        "cpu device csFile output_csFile projectID jobID groupIndex saveLocal "
        "verbose outputWorkspaceID"
    ).split()
    args.all_options = [o for o in all_options if o not in skip]

    # reference check_args (cryosparc.py:267-306): exactly one input
    # source; invalid combinations raise HeliconValidationError
    from ..utils.exceptions import HeliconValidationError

    if (args.projectID or args.jobID) and args.csFile:
        raise HeliconValidationError(
            "specify either server inputs (--projectID --jobID) or local "
            "--csFile, not both"
        )
    if not ((args.projectID and args.jobID) or args.csFile):
        raise HeliconValidationError(
            "specify server inputs (--projectID --jobID) or a local --csFile"
        )
    if args.jobID:
        if len(args.groupIndex) not in (0, len(args.jobID)):
            raise HeliconValidationError(
                f"--groupIndex must be given once per --jobID "
                f"({len(args.jobID)}) or not at all"
            )
        if not args.groupIndex:
            args.groupIndex = [0] * len(args.jobID)
    return args


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__)
    add_args(parser)
    args = parser.parse_args()
    args = check_args(args, parser)
    main(args)
