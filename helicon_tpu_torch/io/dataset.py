"""EMDB dataset access: cached downloads, helical/amyloid entry lists.

A copy of ``helicon_tpu/io/dataset.py`` (host code). Map reading uses the
port's MRC reader; all network access degrades gracefully (with no
network, the entry list is empty). Downloads go through this module's
``download_file_from_url``, which calls the port's
``utils.path_utils.download_file_from_url`` through the module
attribute, so a patch of either intercepts them.
tests/test_torch_dataset.py pins the copy to the original.
"""

from __future__ import annotations

import gzip
import logging
import os
import shutil
from pathlib import Path

import numpy as np
import pandas as pd

from ..utils import path_utils
from ..utils.cache import cache, setup_cache_dir
from ..utils.exceptions import HeliconIOError
from .mrc import read_mrc


def download_file_from_url(url, target_file_name=None, return_filename=False):
    """Download one URL (``utils.path_utils.download_file_from_url``)."""
    return path_utils.download_file_from_url(
        url, target_file_name=target_file_name, return_filename=return_filename
    )

logger = logging.getLogger(__name__)

_cache_dir = setup_cache_dir()

__all__ = [
    "EMDB",
    "get_amyloid_atlas",
    "get_emd_entries",
    "update_helical_parameters_from_curated_table",
]


class EMDB:
    """Singleton EMDB interface: download/cache maps + metadata, iterate
    (map, apix) pairs (dataset.py:21-516)."""

    _instance = None

    def __new__(cls, *args, **kwargs):
        if cls._instance is None:
            cls._instance = super().__new__(cls)
        return cls._instance

    def __init__(self, use_curated_helical_parameters: bool = True, cache_dir=None):
        if getattr(self, "_initialized", False):
            return
        self.emd_ids = []
        self.meta = None
        self.cache_dir = Path(cache_dir) if cache_dir else _cache_dir / "emdb"
        self.cache_dir.mkdir(parents=True, exist_ok=True)
        mirror = os.getenv("EMDB_MIRROR_DIR")
        self.local_emdb_mirror = Path(mirror) if mirror else None
        if self.local_emdb_mirror is not None and not (
            self.local_emdb_mirror.exists() and self.local_emdb_mirror.is_dir()
        ):
            self.local_emdb_mirror = None
        self.update_emd_entries(
            use_curated_helical_parameters=use_curated_helical_parameters
        )
        self._initialized = True

    def update_emd_entries(self, fields=None, use_curated_helical_parameters=True):
        if fields is None:
            fields = [
                "emdb_id",
                "title",
                "structure_determination_method",
                "resolution",
                "fitted_pdbs",
                "image_reconstruction_helical_delta_z_value",
                "image_reconstruction_helical_delta_phi_value",
                "image_reconstruction_helical_axial_symmetry_details",
            ]
        try:
            entries = get_emd_entries(fields=fields)
            if use_curated_helical_parameters:
                entries = update_helical_parameters_from_curated_table(df=entries)
            self.meta = entries.sort_values(by="emd_id", key=lambda x: x.astype(int))
            self.emd_ids = list(self.meta["emd_id"])
        except Exception:
            logger.warning("Failed to obtain the list of EMDB entries", exc_info=True)

    @staticmethod
    def _validate_emd_id(emd_id) -> str:
        s = str(emd_id).lower()
        for prefix in ("emd-", "emd_", "emd"):
            if s.startswith(prefix):
                s = s[len(prefix):]
                break
        s = s.strip("-_ ")
        assert s.isdigit(), f"invalid EMDB id: {emd_id}"
        return s

    def _get_emdb_file(self, emd_id, cache_filename, mirror_relpath, url_method):
        """Cache -> mirror -> remote resolution chain (dataset.py:142-195)."""
        emd_id = self._validate_emd_id(emd_id)
        target_file = self.cache_dir / cache_filename
        if target_file.exists() and target_file.stat().st_size:
            return target_file
        if self.local_emdb_mirror:
            mirror_file = self.local_emdb_mirror / mirror_relpath
            if not (mirror_file.exists() and mirror_file.stat().st_size):
                if os.access(self.local_emdb_mirror, os.W_OK):
                    mirror_file.parent.mkdir(parents=True, exist_ok=True)
                    download_file_from_url(
                        url_method(emd_id), target_file_name=str(mirror_file)
                    )
            if mirror_file.exists() and mirror_file.stat().st_size:
                target_file.unlink(missing_ok=True)
                target_file.symlink_to(mirror_file)
                return target_file
        downloaded = download_file_from_url(
            url_method(emd_id), target_file_name=str(target_file), return_filename=True
        )
        if downloaded is None:
            raise HeliconIOError(f"failed to download {emd_id} from EMDB")
        return Path(downloaded)

    def get_emdb_map_url(self, emd_id) -> str:
        emd_id = self._validate_emd_id(emd_id)
        server = "https://ftp.ebi.ac.uk/pub/databases"
        return f"{server}/emdb/structures/EMD-{emd_id}/map/emd_{emd_id}.map.gz"

    def get_emdb_map_file(self, emd_id):
        emd_id = self._validate_emd_id(emd_id)
        return self._get_emdb_file(
            emd_id,
            cache_filename=f"emd_{emd_id}.map.gz",
            mirror_relpath=f"structures/EMD-{emd_id}/map/emd_{emd_id}.map.gz",
            url_method=self.get_emdb_map_url,
        )

    def read_emdb_map(self, emd_id):
        """(map, apix) for one entry; .map.gz is decompressed into the
        cache on first read (dataset.py:265-289)."""
        emd_id = self._validate_emd_id(emd_id)
        f = self.get_emdb_map_file(emd_id)
        from ..utils.system import optional_loader

        mrcfile = optional_loader("mrcfile", "open")
        if mrcfile is not None:
            # the reference's seam (dataset.py:280-288): mrcfile reads
            # .map.gz transparently and supplies the header for the
            # axis-order normalization
            from .mrc import change_map_axes_order

            with mrcfile.open(f) as mrc:
                apix = float(mrc.voxel_size.x)
                data, _ = change_map_axes_order(
                    mrc.data, mrc.header, new_axes=["x", "y", "z"]
                )
            return np.asarray(data), apix
        f = Path(f)
        if f.suffix == ".gz":
            raw = f.with_suffix("")
            if not (raw.exists() and raw.stat().st_size):
                with gzip.open(f, "rb") as src, open(raw, "wb") as dst:
                    shutil.copyfileobj(src, dst)
            f = raw
        data, apix = read_mrc(f)
        # normalize EMDB maps whose mapc/mapr/maps is not (1, 2, 3) to
        # canonical axis order (reference read_emdb_map ->
        # change_map_axes_order; some EMDB entries are stored permuted)
        from .mrc import change_map_axes_order, mrc_header

        header = mrc_header(f)
        if (header.mapc, header.mapr, header.maps) != (1, 2, 3):
            data, _ = change_map_axes_order(data, header)
        return data, apix

    def get_emdb_xml_url(self, emd_id) -> str:
        emd_id = self._validate_emd_id(emd_id)
        server = "https://ftp.ebi.ac.uk/pub/databases"
        return f"{server}/emdb/structures/EMD-{emd_id}/header/emd-{emd_id}.xml"

    def get_emdb_xml_file(self, emd_id):
        emd_id = self._validate_emd_id(emd_id)
        return self._get_emdb_file(
            emd_id,
            cache_filename=f"emd-{emd_id}.xml",
            mirror_relpath=f"structures/EMD-{emd_id}/header/emd-{emd_id}.xml",
            url_method=self.get_emdb_xml_url,
        )

    def read_emdb_xml(self, emd_id) -> dict:
        """Parse the entry header XML to a nested dict (dataset.py:359-390)."""
        import xml.etree.ElementTree as ET

        f = self.get_emdb_xml_file(emd_id)
        root = ET.parse(f).getroot()

        def parse(node):
            out = {}
            for child in node:
                tag = child.tag.rsplit("}", 1)[-1]
                val = parse(child) if len(child) else (child.text or "").strip()
                if tag in out:
                    if not isinstance(out[tag], list):
                        out[tag] = [out[tag]]
                    out[tag].append(val)
                else:
                    out[tag] = val
            return out

        return {root.tag.rsplit("}", 1)[-1]: parse(root)}

    def get_info(self, emd_id):
        """Metadata row for an entry (dataset.py:391-430)."""
        emd_id = self._validate_emd_id(emd_id)
        if self.meta is None:
            return None
        rows = self.meta[self.meta["emd_id"] == emd_id]
        return rows.iloc[0] if len(rows) else None

    def helical_structure_ids(self):
        ids = self.meta.loc[self.meta["method"] == "helical", "emd_id"]
        return list(ids)

    def amyloid_atlas_ids(self):
        df = get_amyloid_atlas()
        return [
            i
            for i in df["emd_id"].astype(str).str.split("-").str[-1]
            if i in self.emd_ids
        ]

    def __len__(self):
        return len(self.emd_ids)

    def __getitem__(self, i):
        assert 0 <= i < len(self.emd_ids)
        return self.read_emdb_map(self.emd_ids[i])

    def __call__(self, emd_id):
        return self.read_emdb_map(emd_id=emd_id)

    def __iter__(self):
        for emd_id in self.emd_ids:
            yield self.read_emdb_map(emd_id)


@cache(cache_dir=str(_cache_dir), expires_after=7, verbose=0)
def get_emd_entries(fields) -> pd.DataFrame:
    """EMDB search API -> entries table (dataset.py:517-548)."""
    url = (
        'https://www.ebi.ac.uk/emdb/api/search/current_status:"REL"'
        f"?rows=1000000&wt=csv&download=true&fl={','.join(fields)}"
    )
    entries = pd.read_csv(url)
    entries["emd_id"] = entries["emdb_id"].str.split("-", expand=True).iloc[:, 1]
    return entries.rename(
        columns={
            "structure_determination_method": "method",
            "fitted_pdbs": "pdb",
            "image_reconstruction_helical_delta_z_value": "rise",
            "image_reconstruction_helical_delta_phi_value": "twist",
            "image_reconstruction_helical_axial_symmetry_details": "csym",
        }
    )


@cache(cache_dir=str(_cache_dir / "emdb"), expires_after=30, verbose=0)
def get_amyloid_atlas(
    url: str = "https://people.mbi.ucla.edu/sawaya/amyloidatlas",
) -> pd.DataFrame:
    """Amyloid Atlas table mapped to EMDB ids (dataset.py:549-603)."""
    replaced_pdb_ids = {"7z40": "8ade"}
    df = pd.read_html(url, header=0)[0]
    mask = df["PDB ID"].isin(replaced_pdb_ids)
    df.loc[mask, "PDB ID"] = df.loc[mask, "PDB ID"].str.lower().map(replaced_pdb_ids)
    df = df[df["Method"].str.lower() == "cryoem"].copy()
    emdb = EMDB()
    assert emdb.meta is not None, "Failed to get the list of EMDB entries"
    pdb2emd = {}
    for _, row in emdb.meta.iterrows():
        for pdb_id in str(row["pdb"]).lower().split(","):
            if pdb_id:
                pdb2emd[pdb_id] = row["emd_id"]
    df["emd_id"] = df["PDB ID"].str.lower().map(pdb2emd)
    df["sample"] = df["Protein"] + " - " + df["Fibril Origins"]
    df = df.rename(columns={"Resol- ution (Å)": "resolution", "PDB ID": "pdb_id"})
    keep = [
        c
        for c in ("emd_id", "resolution", "pdb_id", "sample", "Residues Ordered", "Reference")
        if c in df
    ]
    df = df[keep].drop_duplicates(subset=["emd_id", "pdb_id"]).reset_index()
    return df


def update_helical_parameters_from_curated_table(
    df: pd.DataFrame,
    url: str = (
        "https://raw.githubusercontent.com/jianglab/"
        "EMDB_helical_parameter_curation/refs/heads/main/EMDB_validation.csv"
    ),
) -> pd.DataFrame:
    """Overlay curated twist/rise/csym values (dataset.py:604-646)."""
    columns = df.columns
    df_curated = pd.read_csv(url)
    df_curated = df_curated[df_curated["emdb_id"].isin(df["emdb_id"])]
    df_curated = df_curated.rename(
        columns={
            "twist_validated (°)": "twist",
            "rise_validated (Å)": "rise",
            "csym_validated": "csym",
        }
    )[["emdb_id", "twist", "rise", "csym"]]
    out = df.merge(df_curated, on="emdb_id", how="left", suffixes=("", "_curated"))
    for k in ("twist", "rise", "csym"):
        out[k] = out[f"{k}_curated"].combine_first(out[k])
    out["twist"] = pd.to_numeric(out["twist"], errors="coerce").round(3)
    out["rise"] = pd.to_numeric(out["rise"], errors="coerce").round(3)
    return out[columns]
