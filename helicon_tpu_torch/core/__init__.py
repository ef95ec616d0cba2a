"""Image-processing core of the PyTorch port (counterpart of
helicon_tpu/core): interpolation, rotation and shift, the chirp-Z and
Fourier filters, the denoisers, the CTF, the correlations, the FSC family
and the helix estimators. The TPU's matmul DFT (``helicon_tpu.core.fft``)
is not ported: ``torch.fft`` takes its place."""

from .czt import czt, zoom_fft_2d, zoom_fft_3d  # noqa: F401
from .denoise import (  # noqa: F401
    denoise_image,
    denoise_nl_means,
    denoise_tv_chambolle,
    denoise_wavelet,
)
from .interp import (  # noqa: F401
    map_coordinates,
    spline_filter,
    spline_filter1d,
    linear_gather_2d,
    trilinear_gather_3d,
)
from .ctf import (  # noqa: F401
    ctf_1d,
    ctf_2d,
    electron_wavelength,
    layer_line_bessel_orders,
    layer_line_positions,
    simulate_helix_power_spectrum,
)
from .rotation import euler_matrix, rot_x, rot_y, rot_z  # noqa: F401
from .transforms import *  # noqa: F401,F403
from .filters import *  # noqa: F401,F403
from .analysis import *  # noqa: F401,F403
from .xcorr import batched_cross_correlation, cross_correlation_map  # noqa: F401
