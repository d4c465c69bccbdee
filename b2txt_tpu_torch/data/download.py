"""Dryad dataset download (reference: download_data.py:44-107).

Enumerates the Dryad dataset's files via API v2 and downloads+unzips them.
Network access is required — in offline environments, point dataset_dir at an
existing copy of hdf5_data_final instead.
"""

from __future__ import annotations

import json
import os
import urllib.parse
import urllib.request
import zipfile
from typing import List, Optional

DRYAD_DOI = "doi:10.5061/dryad.dncjsxm85"
DRYAD_API = "https://datadryad.org/api/v2"


def list_dataset_files(doi: str = DRYAD_DOI) -> List[dict]:
    encoded = urllib.parse.quote(doi, safe="")
    with urllib.request.urlopen(f"{DRYAD_API}/datasets/{encoded}") as r:
        ds = json.load(r)
    version_url = ds["_links"]["stash:version"]["href"]
    with urllib.request.urlopen(
        f"https://datadryad.org{version_url}/files"
    ) as r:
        files = json.load(r)
    return files["_embedded"]["stash:files"]


def download_dataset(
    out_dir: str,
    doi: str = DRYAD_DOI,
    unzip: bool = True,
    skip_existing: bool = True,
) -> List[str]:
    os.makedirs(out_dir, exist_ok=True)
    paths = []
    for f in list_dataset_files(doi):
        name = f["path"]
        dest = os.path.join(out_dir, name)
        if not (skip_existing and os.path.exists(dest)):
            url = "https://datadryad.org" + f["_links"]["stash:download"]["href"]
            print(f"Downloading {name}...")
            urllib.request.urlretrieve(url, dest)
        paths.append(dest)
        if unzip and name.endswith(".zip"):
            with zipfile.ZipFile(dest) as z:
                z.extractall(out_dir)
    return paths
