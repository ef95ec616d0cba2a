"""Where the time and the error of the array compute go on one card.

Runs chip_smoke.py phase 15's inputs through three profiles on the card
(torch.profiler, the device's time by operator: the batched power
spectra of 200 class averages of 384^2, one ePIE epoch of a 128 x 128
scan at batch 256, batched_cross_correlation of 100 x 2,000 segments of
128^2) and measures the chirp-Z's error: for ten of the 200 images, the
spectra with the 2D chirp-Z in complex64 and in complex128, on the card
and on the CPU, against the float64 DFT (at zoom 1 the chirp-Z is the
DFT). From the repository root:

    python3 tools/array_compute_profile.py

Each line ends with the card's name and power limit. Needs one CUDA card.
"""

from __future__ import annotations

import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def _profile(label: str, fn, card: str, rows: int = 12) -> None:
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as p:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = p.key_averages()
    self_ms = lambda e: getattr(e, "self_device_time_total", 0) / 1e3  # noqa: E731
    print(f"{label}: wall {wall * 1e3:.2f} ms, device {sum(map(self_ms, events)):.2f} ms; "
          f"{card}", flush=True)
    for e in sorted(events, key=lambda e: -self_ms(e))[:rows]:
        if self_ms(e) <= 0:
            break
        print(f"    {e.key[:60]:60s} calls {e.count:6d} device {self_ms(e):9.3f} ms")


def _spectra_errors(stack, apix, card: str) -> None:
    """Each spectrum's largest distance from the float64 DFT's, in units of
    its [0, 1] range, by chirp-Z precision and device."""
    import numpy as np
    import torch

    from helicon_tpu_torch.core import czt, transforms

    def exact(img):
        n0, n1 = img.shape
        ph = None
        for n in (n0, n1):
            p = np.exp(2j * np.pi * np.fft.fftfreq(n) * (n / 2.0)) * np.where(np.arange(n) % 2,
                                                                               -1.0, 1.0)
            ph = p if ph is None else ph[:, None] * p
        pw = np.log1p(np.abs(np.fft.fftshift(np.fft.fft2(img.astype(np.float64)) * ph)))
        return (pw - pw.min()) / (pw.max() - pw.min())

    real = czt.czt
    worst = {}
    for dtype in (torch.complex64, torch.complex128):
        czt.czt = lambda *a, _dt=dtype, **kw: real(*a, **{**kw, "dtype": _dt})
        try:
            for dev in ("cuda", "cpu"):
                pwr = transforms.compute_power_spectra_batch(
                    torch.as_tensor(stack[::20], device=dev), apix)[0].cpu().numpy()
                worst[(str(dtype), dev)] = max(float(np.abs(p - exact(x)).max())
                                               for p, x in zip(pwr, stack[::20]))
        finally:
            czt.czt = real
    print("chirp-Z spectra against the float64 DFT (10 images of 384^2, range 1): " + "; ".join(
        f"{dt.split('.')[-1]} {dev} {v:.3e}" for (dt, dev), v in worst.items()) + f"; {card}",
        flush=True)


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("array_compute_profile: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from helicon_tpu_torch.core import ptycho, transforms, xcorr

    dev = torch.device("cuda", 0)
    card = cs._card_line()
    stack, _ = cs._index_stack(dev)
    _spectra_errors(stack, cs.INDEX["apix"], card)
    x = torch.as_tensor(stack, device=dev)
    _profile("compute_power_spectra_batch, 200 x 384^2",
             lambda: transforms.compute_power_spectra_batch(x, cs.INDEX["apix"]), card)
    det = cs.PTYCHO["det"]
    data, vac, _, semi, *_ = cs._ptycho_dataset(cs.PTYCHO["scan"], det, dev)
    amps = torch.as_tensor(np.sqrt(np.clip(data.reshape(-1, det, det), 0, None)), device=dev)
    del data
    probe0 = ptycho._build_probe(vac, (det, det), 8.0, (det / 2, det / 2), 0.0197, semi / 8,
                                 cs.PTYCHO["defocus"])
    ii, jj = np.meshgrid(*(np.arange(cs.PTYCHO["scan"]),) * 2, indexing="ij")
    step = cs.PTYCHO["step_px"]
    pos = np.stack([ii.ravel() * step + 16, jj.ravel() * step + 16], 1).astype(np.int32)
    shape = (int(pos[:, 0].max()) + det + 16,) * 2
    _profile(f"ePIE, one epoch of batch {cs.PTYCHO['batch']}",
             lambda: ptycho._epie_reconstruct(amps, probe0, pos, shape, 1, 0.5,
                                              cs.PTYCHO["batch"]), card)
    g = np.random.default_rng(0)
    m = cs.XCORR["size"]
    cl = torch.as_tensor(g.standard_normal((cs.XCORR["classes"], m, m), dtype=np.float32),
                         device=dev)
    sg = torch.as_tensor(g.standard_normal((2000, m, m), dtype=np.float32), device=dev)
    _profile(f"batched_cross_correlation, {cs.XCORR['classes']} x 2000 of {m}^2",
             lambda: xcorr.batched_cross_correlation(cl, sg), card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
