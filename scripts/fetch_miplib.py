"""Fetch MIPLIB instances and regenerate the reference's missing .npy
blobs (30n20b8.npy, aflow40b.npy — listed in the reference's
.MISSING_LARGE_BLOBS) from their public MPS sources.

Needs network access; in the zero-egress build environment this script
documents the regeneration path and the regression test
(tests/test_utils.py::test_miplib_instance_regression) skips until the
files exist.

Usage: python scripts/fetch_miplib.py [outdir=tests/data/miplib]
"""
import os
import sys
import urllib.request

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from interiorpoint.utils.mps import mps_to_npy  # noqa: E402

URL = "https://miplib.zib.de/WebData/instances/{name}.mps.gz"
INSTANCES = ("30n20b8", "aflow40b")

outdir = sys.argv[1] if len(sys.argv) > 1 else "tests/data/miplib"
os.makedirs(outdir, exist_ok=True)

for name in INSTANCES:
    gz = os.path.join(outdir, f"{name}.mps.gz")
    npy = os.path.join(outdir, f"{name}.npy")
    if not os.path.exists(gz):
        print("downloading", URL.format(name=name), flush=True)
        urllib.request.urlretrieve(URL.format(name=name), gz)
    arrays = mps_to_npy(gz, npy)
    c, A, b, C, d, ub, lb = arrays
    print(f"{name}: n={len(c)} eq={A.shape[0]} ineq={C.shape[0]} -> {npy}",
          flush=True)
