"""MRC2014 reader and writer for the port (no mrcfile dependency).

A copy of ``helicon_tpu/io/mrc.py``: the 1024-byte header (modes 0/1/2/4/6/12,
voxel size from the cell and mx), one image of a stack, the whole file
(memory-mapped on request), the writer, the streaming writer
``create_mrc_memmap``, the stack sizes, ``change_map_axes_order`` and the
matplotlib viewer ``display_map_orthoslices`` (matplotlib imported inside
it, as the reference does).
tests/test_torch_io.py pins the copy to the original in both directions.
"""

from __future__ import annotations

import dataclasses
import struct

import numpy as np

__all__ = [
    "create_mrc_memmap",
    "MrcHeader",
    "change_map_axes_order",
    "display_map_orthoslices",
    "get_image_number",
    "get_image_size",
    "mrc_header",
    "read_image_2d",
    "read_mrc",
    "write_mrc",
]

_MODE_DTYPES = {
    0: np.dtype(np.int8),
    1: np.dtype(np.int16),
    2: np.dtype(np.float32),
    4: np.dtype(np.complex64),
    6: np.dtype(np.uint16),
    12: np.dtype(np.float16),
}
_DTYPE_MODES = {v: k for k, v in _MODE_DTYPES.items()}


@dataclasses.dataclass
class MrcHeader:
    nx: int
    ny: int
    nz: int
    mode: int
    nxstart: int = 0
    nystart: int = 0
    nzstart: int = 0
    mx: int = 0
    my: int = 0
    mz: int = 0
    xlen: float = 0.0
    ylen: float = 0.0
    zlen: float = 0.0
    alpha: float = 90.0
    beta: float = 90.0
    gamma: float = 90.0
    mapc: int = 1
    mapr: int = 2
    maps: int = 3
    dmin: float = 0.0
    dmax: float = 0.0
    dmean: float = 0.0
    ispg: int = 0
    nsymbt: int = 0
    origin: tuple = (0.0, 0.0, 0.0)
    rms: float = 0.0
    nlabl: int = 0

    @property
    def voxel_size(self):
        """(apix_x, apix_y, apix_z); 0 when the cell is unset."""
        mx = self.mx or self.nx
        my = self.my or self.ny
        mz = self.mz or self.nz
        return (
            self.xlen / mx if mx else 0.0,
            self.ylen / my if my else 0.0,
            self.zlen / mz if mz else 0.0,
        )

    @property
    def apix(self) -> float:
        return float(self.voxel_size[0])

    @property
    def dtype(self):
        return _MODE_DTYPES[self.mode]

    @property
    def shape(self):
        return (self.nz, self.ny, self.nx)

    @property
    def data_offset(self) -> int:
        return 1024 + self.nsymbt


def mrc_header(path) -> MrcHeader:
    """Parse the fixed 1024-byte header."""
    with open(path, "rb") as f:
        raw = f.read(1024)
    if len(raw) < 1024:
        raise ValueError(f"{path}: truncated MRC header ({len(raw)} bytes)")
    ints = struct.unpack("<10i", raw[0:40])
    cella = struct.unpack("<3f", raw[40:52])
    cellb = struct.unpack("<3f", raw[52:64])
    mapc, mapr, maps = struct.unpack("<3i", raw[64:76])
    dmin, dmax, dmean = struct.unpack("<3f", raw[76:88])
    ispg, nsymbt = struct.unpack("<2i", raw[88:96])
    origin = struct.unpack("<3f", raw[196:208])
    rms = struct.unpack("<f", raw[216:220])[0]
    nlabl = struct.unpack("<i", raw[220:224])[0]
    h = MrcHeader(
        nx=ints[0], ny=ints[1], nz=ints[2], mode=ints[3],
        nxstart=ints[4], nystart=ints[5], nzstart=ints[6],
        mx=ints[7], my=ints[8], mz=ints[9],
        xlen=cella[0], ylen=cella[1], zlen=cella[2],
        alpha=cellb[0], beta=cellb[1], gamma=cellb[2],
        mapc=mapc, mapr=mapr, maps=maps,
        dmin=dmin, dmax=dmax, dmean=dmean,
        ispg=ispg, nsymbt=nsymbt, origin=origin, rms=rms, nlabl=nlabl,
    )
    if h.mode not in _MODE_DTYPES:
        raise ValueError(f"{path}: unsupported MRC mode {h.mode}")
    return h


def read_mrc(path, mmap: bool = False):
    """The whole file as (data (nz, ny, nx) in its own dtype, apix); with
    mmap a read-only memory map that reads the voxels when sliced."""
    h = mrc_header(path)
    if mmap:
        data = np.memmap(path, dtype=h.dtype, mode="r", offset=h.data_offset, shape=h.shape)
        return data, h.apix
    data = np.fromfile(path, dtype=h.dtype, count=h.nx * h.ny * h.nz, offset=h.data_offset)
    return data.reshape(h.shape), h.apix


def write_mrc(path, data, apix: float = 1.0, is_stack: bool | None = None):
    """Write (nz, ny, nx) or (ny, nx) data as MRC2014 (mode from the dtype;
    other dtypes as float32). is_stack marks an image stack (ispg 0, mz 1);
    by default a ``.mrcs`` suffix does."""
    data = np.asarray(data)
    if data.ndim == 2:
        data = data[None]
    if data.ndim != 3:
        raise ValueError(f"write_mrc: expected 2 or 3 dimensions, got {data.ndim}")
    dt = data.dtype.newbyteorder("=")
    if np.dtype(dt) not in _DTYPE_MODES:
        data = data.astype(np.float32)
        dt = data.dtype
    mode = _DTYPE_MODES[np.dtype(dt)]
    nz, ny, nx = data.shape
    if is_stack is None:
        is_stack = str(path).endswith(".mrcs")
    mz = 1 if is_stack else nz

    dmin = float(np.min(data.real)) if data.size else 0.0
    dmax = float(np.max(data.real)) if data.size else 0.0
    dmean = float(np.mean(data.real)) if data.size else 0.0
    rms = float(np.std(data.real)) if data.size else 0.0

    hdr = bytearray(1024)
    struct.pack_into("<10i", hdr, 0, nx, ny, nz, mode, 0, 0, 0, nx, ny, mz)
    struct.pack_into("<3f", hdr, 40, nx * apix, ny * apix, mz * apix)
    struct.pack_into("<3f", hdr, 52, 90.0, 90.0, 90.0)
    struct.pack_into("<3i", hdr, 64, 1, 2, 3)
    struct.pack_into("<3f", hdr, 76, dmin, dmax, dmean)
    struct.pack_into("<2i", hdr, 88, 0 if is_stack else 1, 0)
    struct.pack_into("<3f", hdr, 196, 0.0, 0.0, 0.0)
    hdr[208:212] = b"MAP "
    hdr[212:216] = bytes([0x44, 0x44, 0x00, 0x00])  # little-endian machst
    struct.pack_into("<f", hdr, 216, rms)
    struct.pack_into("<i", hdr, 220, 1)
    label = b"helicon-tpu"
    hdr[224 : 224 + len(label)] = label
    with open(path, "wb") as f:
        f.write(bytes(hdr))
        data.astype(dt, copy=False).tofile(f)


def read_image_2d(path, index: int = 0) -> np.ndarray:
    """One 2D image (0-based index) of a stack, as float32, without
    reading the rest."""
    h = mrc_header(path)
    if not 0 <= index < h.nz:
        raise IndexError(f"{path}: image {index} out of range (nz={h.nz})")
    n = h.nx * h.ny
    offset = h.data_offset + index * n * h.dtype.itemsize
    img = np.fromfile(path, dtype=h.dtype, count=n, offset=offset)
    return img.reshape(h.ny, h.nx).astype(np.float32)


def create_mrc_memmap(path, shape, dtype=np.float32, apix: float = 1.0,
                      is_stack: bool | None = None):
    """Create an MRC2014 file of the given (nz, ny, nx) shape and return
    a writable np.memmap over its data region — the streaming writer for
    stacks too large to hold in RAM (the reference uses mrcfile.new_mmap).
    The dmin/dmax/dmean/rms header fields are left 0 (unset)."""
    nz, ny, nx = shape
    dt = np.dtype(dtype).newbyteorder("=")
    assert np.dtype(dt) in _DTYPE_MODES, dt
    mode = _DTYPE_MODES[np.dtype(dt)]
    if is_stack is None:
        is_stack = str(path).endswith(".mrcs")
    mz = 1 if is_stack else nz
    hdr = bytearray(1024)
    struct.pack_into("<10i", hdr, 0, nx, ny, nz, mode, 0, 0, 0, nx, ny, mz)
    struct.pack_into("<3f", hdr, 40, nx * apix, ny * apix, mz * apix)
    struct.pack_into("<3f", hdr, 52, 90.0, 90.0, 90.0)
    struct.pack_into("<3i", hdr, 64, 1, 2, 3)
    struct.pack_into("<2i", hdr, 88, 0 if is_stack else 1, 0)
    hdr[208:212] = b"MAP "
    hdr[212:216] = bytes([0x44, 0x44, 0x00, 0x00])
    struct.pack_into("<i", hdr, 220, 1)
    label = b"helicon-tpu"
    hdr[224 : 224 + len(label)] = label
    with open(path, "wb") as f:
        f.write(bytes(hdr))
    return np.memmap(path, dtype=dt, mode="r+", offset=1024, shape=tuple(shape))


def get_image_number(path) -> int:
    """Number of images in a 2D stack (io_mrc.py:20-44)."""
    return mrc_header(path).nz


def get_image_size(path):
    """(ny, nx) of images in the file (io_mrc.py:45-70)."""
    h = mrc_header(path)
    return (h.ny, h.nx)


def change_map_axes_order(data, header_or_order="zyx", new_axes=None):
    """Reorder volume axes (io_mrc.py:101-135).

    Two call forms:
    - change_map_axes_order(data, header, new_axes=["x","y","z"]) — the
      reference form: permute by the MRC header's mapc/mapr/maps so the
      data lands in canonical axis order; returns (data, updated_header).
    - change_map_axes_order(data, "xyz") — permute a (z, y, x) array to
      the given string order; returns the array.
    """
    if isinstance(header_or_order, str):
        order = header_or_order.lower()
        assert sorted(order) == ["x", "y", "z"], order
        perm = ["zyx".index(a) for a in order]
        return np.transpose(np.asarray(data), perm)
    header = header_or_order
    if new_axes is None:
        new_axes = ["x", "y", "z"]
    map_axes = {"x": 0, "y": 1, "z": 2}
    try:
        # physical axis (0=X, 1=Y, 2=Z) stored along each numpy axis:
        # numpy axis 0 = sections (maps), 1 = rows (mapr), 2 = cols (mapc)
        cur_phys = [header.maps - 1, header.mapr - 1, header.mapc - 1]
    except AttributeError:
        cur_phys = [2, 1, 0]
    target = [map_axes[a] for a in new_axes]  # (mapc, mapr, maps) - 1 out
    # DEVIATION from reference io_mrc.py:101-133, which computes
    # moveaxis(data, [mapc-1, mapr-1, maps-1], [0, 1, 2]) — wrong for
    # non-self-inverse orders (e.g. (2,1,3): a [Z][X][Y] map came back
    # [X][Z][Y] instead of [Z][Y][X]). Correct: send the numpy axis
    # holding physical axis q to the output position that stores q.
    dest = [2 - target.index(q) for q in cur_phys]
    data2 = np.moveaxis(np.asarray(data), [0, 1, 2], dest)
    import dataclasses

    if dataclasses.is_dataclass(header):
        header2 = dataclasses.replace(
            header, mapc=target[0] + 1, mapr=target[1] + 1, maps=target[2] + 1
        )
    else:
        # foreign header object (e.g. an mrcfile header): hand it back
        # untouched — callers use only the permuted data
        header2 = header
    return data2, header2


def display_map_orthoslices(data, title: str = "", apix: float = 1.0, show=True):
    """Matplotlib figure of the three central orthoslices
    (io_mrc.py:136-173)."""
    import matplotlib

    if not show:
        matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    data = data.cpu().numpy() if hasattr(data, "cpu") else np.asarray(data)
    nz, ny, nx = data.shape
    fig, axes = plt.subplots(1, 3, figsize=(12, 4))
    for ax, (img, name) in zip(
        axes,
        [
            (data[nz // 2], "XY"),
            (data[:, ny // 2, :], "XZ"),
            (data[:, :, nx // 2], "YZ"),
        ],
    ):
        ax.imshow(img, cmap="gray", origin="lower")
        ax.set_title(f"{title} {name}".strip())
        ax.axis("off")
    fig.tight_layout()
    if show:
        plt.show()
    return fig
