"""Facade matching the reference's ``webApps/denovo3D/pipeline.py``: the
single-task pipeline and the image loaders (a copy of
``helicon_tpu/webApps/denovo3D/pipeline.py``'s loaders; the URL and EMDB
ones need a network)."""

from ...denovo3d.pipeline import (  # noqa: F401
    derive_task_geometry,
    prepare_data,
    process_one_task,
)
from ...utils.cache import cache, setup_cache_dir
from ...utils.path_utils import download_file_from_url

_cache_dir = setup_cache_dir()


def get_images_from_file(imageFile):
    """(stack (n, ny, nx), apix rounded to 4 places) of a local MRC file."""
    import numpy as np

    from ...io.mrc import read_mrc

    data, apix = read_mrc(imageFile)
    return np.asarray(data), round(float(apix), 4)


@cache(cache_dir=str(_cache_dir / "denovo3D"), expires_after=7, verbose=0)
def get_images_from_url(url: str):
    """Download an image stack from a URL (reference pipeline.py:9-27)."""
    import tempfile
    from pathlib import Path

    import numpy as np

    from ...io.mrc import read_mrc

    tmp = Path(tempfile.mkdtemp()) / Path(url).name
    download_file_from_url(url, target_file_name=str(tmp))
    data, apix = read_mrc(tmp)
    return np.asarray(data), apix


@cache(cache_dir=str(_cache_dir / "denovo3D"), expires_after=7, verbose=0)
def get_images_from_emdb(emd_id: str):
    """EMDB map -> (map, apix) (reference pipeline.py:29-43)."""
    from ...io.dataset import EMDB

    return EMDB().read_emdb_map(emd_id)
