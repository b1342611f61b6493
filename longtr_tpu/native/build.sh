#!/bin/sh
# Build the native I/O library. Requires g++ and zlib (both baked in).
set -e
cd "$(dirname "$0")"
# -ffp-contract=off: FMA contraction changes last-ulp pair-HMM results and
# would break the enforced bit-identity with the jnp scan / CUDA kernel.
# Must match the flags in native/__init__.py's auto-build.
g++ -O3 -march=native -ffp-contract=off -shared -fPIC -o liblongtr_native.so longtr_native.cc -lz
echo "built $(pwd)/liblongtr_native.so"
