"""Download helpers (reference: seqvec_search/utils.py:116-119)."""

import gzip
import shutil
import urllib.request
from pathlib import Path


def download_and_extract(url: str, filename: Path) -> None:
    """Stream-decompress a .gz URL to a file."""
    with urllib.request.urlopen(url) as fp, open(filename, "wb") as target:
        unzipped = gzip.open(fp)
        shutil.copyfileobj(unzipped, target)
