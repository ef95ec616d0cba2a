"""Facade matching the reference's ``webApps/denovo3D/pipeline.py``: the
single-task pipeline and the image loaders.

The URL and EMDB loaders need the cache, path and dataset utilities and a
network (ROADMAP A13); they raise NotImplementedError.
"""

from ...denovo3d.pipeline import (  # noqa: F401
    derive_task_geometry,
    prepare_data,
    process_one_task,
)


def get_images_from_file(imageFile):
    """(stack (n, ny, nx), apix rounded to 4 places) of a local MRC file."""
    import numpy as np

    from ...io.mrc import read_mrc

    data, apix = read_mrc(imageFile)
    return np.asarray(data), round(float(apix), 4)


def get_images_from_url(url: str):
    """Not ported: downloading needs ROADMAP A13's cache and path utilities."""
    raise NotImplementedError("get_images_from_url is not ported yet (ROADMAP A13)")


def get_images_from_emdb(emd_id: str):
    """Not ported: EMDB maps need ROADMAP A13's io/dataset."""
    raise NotImplementedError("get_images_from_emdb is not ported yet (ROADMAP A13)")
