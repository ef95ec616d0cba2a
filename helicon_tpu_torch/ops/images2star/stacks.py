"""Stack-building options: createStack, fullStack, minStack,
selectByParticleLocation.

The port's counterpart of ``helicon_tpu/ops/images2star/stacks.py``.
createStack reads a chunk of images on the host, crops or pads the chunk
on the command's device (``fft_crop`` / ``pad_to_size``, one upload and
one download per chunk) and writes it into the memory-mapped stack in the
original's row order. fullStack, minStack and selectByParticleLocation
(scipy ``distance`` on the host) are copies; tests/test_torch_images2star.py
holds the options to the original.
"""

from __future__ import annotations

import logging
from pathlib import Path

import numpy as np
import pandas as pd

from ...utils.collections import unique_attr_name
from ...utils.exceptions import HeliconError
from ...utils.path_utils import convert_dataframe_file_path
from ...utils.system import parse_param_str
from ..registry import Plugin

logger = logging.getLogger(__name__)


def _add_createStack(parser):
    parser.add_argument(
        "--createStack", type=str, default="",
        metavar="<output.mrcs<:rescale2size=n:float16=0|1:force=0|1>>",
        help="write a consolidated .mrcs particle stack",
    )


# images of a createStack chunk: at most this many input pixels a chunk
STACK_CHUNK_PIXELS = 1 << 24
# source stacks whose memory maps createStack keeps open at once: each map
# holds a file descriptor, and a project extracted one stack per micrograph
# has thousands of stacks
STACK_OPEN_MAPS = 64


def _image_reader():
    """read(name, index) of one image from memory maps, at most
    STACK_OPEN_MAPS of them open, the least recently used dropped first (a
    map closes its file with its last reference; the original's
    read_image_2d opens the file per image). The image is a view into its
    map, which stays open while the view lives."""
    from collections import OrderedDict

    from ...io.mrc import read_mrc

    maps: OrderedDict = OrderedDict()

    def read(name, index):
        mm = maps.pop(name, None)
        if mm is None:
            while len(maps) >= max(1, STACK_OPEN_MAPS):
                maps.popitem(last=False)
            mm = read_mrc(name, mmap=True)[0]
        maps[name] = mm
        if not 0 <= index < mm.shape[0]:
            raise IndexError(f"{name}: image {index} out of range (nz={mm.shape[0]})")
        return mm[index]

    return read


def _h_createStack(data, args, index_d, param):
    import torch

    from ...commands import command_device
    from ...core.transforms import fft_crop, pad_to_size
    from ...io.mrc import get_image_size, mrc_header

    if param:
        outputFile, pd_ = parse_param_str(param)
        if Path(outputFile).suffix != ".mrcs":
            logger.error("a .mrcs file is expected, got %s; skipping", outputFile)
            return data, index_d
        images = data["rlnImageName"].str.split("@", expand=True)
        images.columns = ["pid", "filename"]
        images["pid"] = images["pid"].astype(int)
        attr = unique_attr_name(data, attr_prefix="rlnImageNameOrig")
        data[attr] = data["rlnImageName"]
        ny, nx = get_image_size(images["filename"].iloc[0])
        nImage = len(data)
        newsize = int(pd_.get("rescale2size", nx))
        float16 = int(pd_.get("float16", 1))
        force = int(pd_.get("force", 0))
        if not force:
            if Path(outputFile).exists():
                h = mrc_header(outputFile)
                if not (h.nx == newsize and h.ny == newsize and h.nz == nImage):
                    force = 1
            else:
                force = 1
        if force:
            from ...io.mrc import create_mrc_memmap

            device = command_device(getattr(args, "device", "cuda"))
            apix0 = mrc_header(images["filename"].iloc[0]).apix
            # stream into a memory-mapped MRC: a 500k x 400^2 stack is
            # hundreds of GB — the reference writes via mrcfile.new_mmap
            stack = create_mrc_memmap(
                outputFile, (nImage, newsize, newsize),
                np.float16 if float16 else np.float32,
                apix=apix0 * nx / newsize,
            )
            read = _image_reader()
            names = images["filename"].to_numpy()
            pids = images["pid"].to_numpy()
            chunk = max(1, STACK_CHUNK_PIXELS // (ny * nx))
            buf = np.empty((min(chunk, nImage), ny, nx), np.float32)
            for i0 in range(0, nImage, chunk):
                i1 = min(i0 + chunk, nImage)
                for i in range(i0, i1):
                    buf[i - i0] = read(names[i], int(pids[i]) - 1)
                d = torch.from_numpy(buf[: i1 - i0]).to(device)
                if newsize < nx:
                    d = fft_crop(d, (newsize, newsize))
                elif newsize > nx:
                    d = pad_to_size(d, (i1 - i0, newsize, newsize))
                stack[i0:i1] = d.cpu().numpy()
            stack.flush()
            del stack
        data["rlnImageName"] = (
            pd.Series(np.arange(nImage) + 1, index=data.index).astype(str)
            + "@"
            + outputFile
        )
        optics = data.attrs.get("optics")
        if optics is not None and newsize != nx:
            optics["rlnImageSize"] = newsize
            if "rlnImagePixelSize" in optics:
                optics["rlnImagePixelSize"] = (
                    optics["rlnImagePixelSize"] * nx / newsize
                )
        index_d["createStack"] += 1
    return data, index_d


def _add_fullStack(parser):
    parser.add_argument(
        "--fullStack", type=int, metavar="<0|1>", default=0,
        help="expand the selection to every image of each referenced stack",
    )


def _h_fullStack(data, args, index_d, param):
    from ...io.mrc import get_image_number

    if param:
        valid_cols = set(
            "rlnVoltage rlnDefocusU rlnDefocusV rlnDefocusAngle "
            "rlnSphericalAberration rlnDetectorPixelSize rlnMagnification "
            "rlnAmplitudeContrast rlnMicrographName rlnGroupName "
            "rlnGroupNumber".split()
        )
        cols_to_keep = [c for c in data if c in valid_cols]
        names = data["rlnImageName"].str.split("@", expand=True).iloc[:, -1]
        frames = []
        for name, particles in names.groupby(names, sort=False):
            n = get_image_number(name)
            df = pd.DataFrame(
                {
                    "rlnImageName": pd.Series(range(1, n + 1)).map(
                        "{:06d}".format
                    )
                    + "@"
                    + name
                }
            )
            tmpdf = data.loc[particles.index]
            for c in cols_to_keep:
                df[c] = tmpdf[c].values[0]
            frames.append(df)
        attrs = dict(data.attrs)
        data = pd.concat(frames).reset_index(drop=True)
        data.attrs.update(attrs)
        index_d["fullStack"] += 1
    return data, index_d


def _add_minStack(parser):
    parser.add_argument(
        "--minStack", type=int, metavar="<0|1>", default=0,
        help="write minimal per-micrograph stacks with only selected images",
    )


def _h_minStack(data, args, index_d, param):
    from ...io.mrc import get_image_number, mrc_header, read_image_2d, write_mrc

    if param:
        tmp = data["rlnImageName"].str.split("@", expand=True)
        indices, names = tmp.iloc[:, 0], tmp.iloc[:, -1]
        subdir = Path(
            getattr(args, "output_starFile", "output.star")
        ).with_suffix("")
        subdir.mkdir(exist_ok=True)
        used: dict = {}  # output basename -> source stack path
        for name, particles in names.groupby(names, sort=False):
            base = Path(name).name
            if used.get(base, name) != name:
                # two different source stacks share a basename: writing
                # both to subdir/<basename> would silently cross-match
                # the second stack's metadata to the first stack's images
                stem, suf = Path(base).stem, Path(base).suffix
                k = 2
                while used.get(f"{stem}-{k}{suf}", name) != name:
                    k += 1
                base = f"{stem}-{k}{suf}"
            used[base] = name
            name2 = subdir / base
            n = len(particles)
            if not (name2.exists() and get_image_number(name2) == n):
                # write in DATAFRAME ROW order so slot i of the new stack
                # is the particle renamed to i+1 below. (The reference
                # writes slots in sorted-pid order while renaming in row
                # order, silently cross-matching images and metadata when
                # rows are not pid-ascending, e.g. after --sortby.)
                pids = indices.loc[particles.index].astype(int)
                apix = mrc_header(name).apix
                imgs = np.stack(
                    [read_image_2d(name, pid - 1) for pid in pids]
                )
                write_mrc(name2, imgs, apix=apix)
            new_names = (
                pd.Series(range(1, n + 1)).map("{:06d}".format) + "@" + str(name2)
            )
            data.loc[particles.index, "rlnImageName"] = new_names.values
        index_d["minStack"] += 1
    return data, index_d


def _add_selectByParticleLocation(parser):
    parser.add_argument(
        "--selectByParticleLocation", type=str, action="append", default=[],
        metavar="<starFile:maxDist=<pixels>>",
        help="select particles whose micrograph location matches the file",
    )


def _h_selectByParticleLocation(data, args, index_d, param):
    from ...io.metadata import images2dataframe
    from scipy.spatial import distance

    if len(param) > 0:
        required = ["rlnMicrographName", "rlnCoordinateX", "rlnCoordinateY"]
        missing = [p for p in required if p not in data]
        if missing:
            raise HeliconError(f"required parameters {' '.join(missing)} missing")
        sf, pd_ = parse_param_str(param)
        maxDist = float(pd_.get("maxDist", 5))
        if sf is None or not Path(sf).exists():
            raise HeliconError(f"{sf} does not exist")
        data_sf = images2dataframe(
            sf,
            alternative_folders=getattr(args, "folder", []),
            warn_missing_ctf=0,
            target_convention="relion",
        )
        missing = [p for p in required if p not in data_sf]
        if missing:
            raise HeliconError(
                f"required parameters {' '.join(missing)} missing in {sf}"
            )
        key = "sbpl_rlnMicrographName"
        data[key] = convert_dataframe_file_path(data, "rlnMicrographName", to="abs")
        data_sf[key] = convert_dataframe_file_path(
            data_sf, "rlnMicrographName", to="abs"
        )
        group2 = {g: gdf for g, gdf in data_sf.groupby(key)}
        matched = []
        for gname, g in data.groupby(key):
            if gname not in group2:
                continue
            loc = g[["rlnCoordinateX", "rlnCoordinateY"]].values
            loc2 = group2[gname][["rlnCoordinateX", "rlnCoordinateY"]].values
            dist = distance.cdist(loc, loc2, "euclidean")
            rows = np.where(np.min(dist, axis=1) <= maxDist)[0]
            matched += list(g.index[rows])
        attrs = dict(data.attrs)
        data = data.loc[sorted(matched)].drop(columns=[key]).reset_index(drop=True)
        data.attrs.update(attrs)
        if len(data) < 1:
            raise HeliconError("--selectByParticleLocation retained no particle")
        index_d["selectByParticleLocation"] += 1
    return data, index_d


PLUGINS = [
    Plugin("createStack", _add_createStack, _h_createStack),
    Plugin("fullStack", _add_fullStack, _h_fullStack),
    Plugin("minStack", _add_minStack, _h_minStack),
    Plugin(
        "selectByParticleLocation",
        _add_selectByParticleLocation,
        _h_selectByParticleLocation,
    ),
]
