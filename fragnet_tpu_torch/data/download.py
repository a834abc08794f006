"""MoleculeNet raw-CSV downloader (counterpart of
fragnet_tpu/data/download.py) — the analog of the torch_geometric
``MoleculeNet`` dataset downloads the reference relies on
(fragnet/dataset/moleculenet.py:13-85 via PyG, loader_molebert raw files).

Everything else in this package reads local CSVs (or generates synthetic
stand-ins); this module is the explicit network step for machines that
have egress. URLs are the canonical DeepChem S3 objects PyG itself fetches;
``url`` also takes a ``file://`` URL (a local mirror).

    python -m fragnet_tpu_torch.data.download --dataset esol --out data/raw
"""

from __future__ import annotations

import gzip
import io
import os
from typing import Dict, Optional

# canonical deepchem S3 objects (the same ones torch_geometric's
# MoleculeNet dataset downloads)
_S3 = "https://deepchemdata.s3-us-west-1.amazonaws.com/datasets"
DOWNLOAD_REGISTRY: Dict[str, str] = {
    "esol": f"{_S3}/delaney-processed.csv",
    "freesolv": f"{_S3}/SAMPL.csv",
    "lipo": f"{_S3}/Lipophilicity.csv",
    "bace": f"{_S3}/bace.csv",
    "bbbp": f"{_S3}/BBBP.csv",
    "clintox": f"{_S3}/clintox.csv.gz",
    "hiv": f"{_S3}/HIV.csv",
    "sider": f"{_S3}/sider.csv.gz",
    "tox21": f"{_S3}/tox21.csv.gz",
    "toxcast": f"{_S3}/toxcast_data.csv.gz",
    "muv": f"{_S3}/muv.csv.gz",
    "pcba": f"{_S3}/pcba.csv.gz",
}


def download_moleculenet(name: str, out_dir: str,
                         url: Optional[str] = None,
                         timeout: float = 60.0) -> str:
    """Fetch a raw MoleculeNet CSV into ``out_dir/<name>.csv`` (gz files are
    decompressed). ``url`` overrides the registry (also accepts file:// for
    tests/mirrors). Raises a clear error when the machine has no egress."""
    from fragnet_tpu_torch.data.moleculenet import _canonical_name

    key = _canonical_name(name)
    url = url or DOWNLOAD_REGISTRY.get(key)
    if url is None:
        raise KeyError(f"no download URL registered for {name!r}")
    os.makedirs(out_dir, exist_ok=True)
    dest = os.path.join(out_dir, f"{key}.csv")
    if os.path.exists(dest):
        return dest

    import urllib.error
    import urllib.request

    try:
        with urllib.request.urlopen(url, timeout=timeout) as r:
            raw = r.read()
    except (urllib.error.URLError, OSError) as e:
        raise ConnectionError(
            f"could not download {url}: {e}. This environment may have no "
            f"network egress — place the raw CSV at {dest} manually (the "
            f"rest of the pipeline is download-free)."
        ) from e
    if url.endswith(".gz"):
        raw = gzip.decompress(raw)
    with open(dest, "wb") as f:
        f.write(raw)
    return dest


def main():
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--url", default=None)
    args = ap.parse_args()
    path = download_moleculenet(args.dataset, args.out, url=args.url)
    print(f"downloaded -> {path}")


if __name__ == "__main__":
    main()
