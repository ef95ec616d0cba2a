"""The flat namespace of ``helicon_tpu_torch`` (the names of
``helicon_tpu/__init__.py:11-139`` but the TPU-only ones): imported by the
package on the first access of one of its names, so that a command, which
imports only its own modules, does not pay for the whole library at
start-up."""

from helicon_tpu_torch.utils import *  # noqa: F401,F403
from helicon_tpu_torch.utils.cache import DummyMemory, cache, setup_cache_dir  # noqa: F401
from helicon_tpu_torch.core import *  # noqa: F401,F403
from helicon_tpu_torch.core.alignment import align_images, phase_cross_correlation  # noqa: F401
from helicon_tpu_torch.core.curvelet import (  # noqa: F401
    curvelet_denoise_3d_mct,
    curvelet_denoise_3d_mct_tiled,
    curvelet_denoise_3d_udct,
    curvelet_denoise_3d_udct_tiled,
    curvelet_denoise_batch_fdct,
    curvelet_denoise_batch_mct,
    curvelet_denoise_batch_udct,
    curvelet_denoise_fdct,
    curvelet_denoise_fdct_tiled,
    curvelet_denoise_mct,
    curvelet_denoise_mct_tiled,
    curvelet_denoise_udct,
    curvelet_denoise_udct_tiled,
)
from helicon_tpu_torch.angular import *  # noqa: F401,F403
from helicon_tpu_torch.gauss import (  # noqa: F401
    AnisotropicGaussian,
    AnisotropicGaussianSet,
    IsotropicGaussian,
    IsotropicGaussianSet,
)
from helicon_tpu_torch.io.mrc import (  # noqa: F401
    change_map_axes_order,
    display_map_orthoslices,
    get_image_number,
    get_image_size,
    read_image_2d,
    read_mrc,
    write_mrc,
)
from helicon_tpu_torch.io.metadata import (  # noqa: F401
    Relion_OpticsGroup_Parameters,
    assign_beamshifts_to_cluster,
    cistem2dataframe,
    clean_cs_micrograph_path,
    connect_cryosparc,
    cs2dataframe,
    csv2dataframe,
    dataframe2cs,
    dataframe2file,
    dataframe2star,
    dataframe_convert,
    dataframe_cryosparc_to_relion,
    dataframe_relion_to_cryosparc,
    dataframe_guess_data_type,
    dataframe_normalize_filename,
    eman_astigmatism_to_relion,
    getPixelSize,
    get_dataframe_convention,
    get_relion_project_folder,
    guess_data_type,
    image2dataframe,
    images2dataframe,
    mrc2mrcs,
    pixelSizeAttrForImageAttr,
    relion_astigmatism_to_eman,
    setPixelSize,
    star2dataframe,
    star_build_opticsgroup,
    star_dissolve_opticsgroup,
    star_to_dataframe,
)
from helicon_tpu_torch.io.epu import (  # noqa: F401
    EPU_micrograph_path_2_movie_xml_path,
    EPU_xml_2_beamshift,
    assign_beamshift_groups,
    check_foilhole_xml_files,
    extract_beamshift,
    extract_data_collection_time,
    guess_data_collection_software,
    movie_filename_patterns,
    verify_data_collection_software,
)
from helicon_tpu_torch.io.groups import (  # noqa: F401
    assign_time_groups,
    combine_groups,
    extract_timestamps,
    per_micrograph_ids,
    per_micrograph_mapping,
    propagate_ctf_median,
    sync_group_columns,
)
from helicon_tpu_torch.helix import *  # noqa: F401,F403
from helicon_tpu_torch.point_group import PointGroup  # noqa: F401
from helicon_tpu_torch.clustering import AgglomerativeClusteringWithMinSize  # noqa: F401

from helicon_tpu_torch import angular  # noqa: F401,E402
from helicon_tpu_torch import core  # noqa: F401,E402
from helicon_tpu_torch import euler  # noqa: F401,E402
from helicon_tpu_torch import utils  # noqa: F401,E402
from helicon_tpu_torch.core import curvelet  # noqa: F401,E402
from helicon_tpu_torch.utils import shiny  # noqa: F401,E402
