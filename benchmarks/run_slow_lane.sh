#!/bin/sh
# The marked-slow regression lane: everything the default suite gates
# behind HDSDP_SLOW (the m >= 4096 AdaptiveCG path and the m = n = 10648
# row-sharded mesh dryrun).  Runs on the CPU; ~10-15 min uncontended.
set -x
cd "$(dirname "$0")/.." || exit 1
HDSDP_SLOW=1 JAX_PLATFORMS=cpu python -m pytest \
    tests/test_scale_slow.py -q "$@"
