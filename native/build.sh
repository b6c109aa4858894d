#!/bin/sh
# Build the native helpers into native/build/ (listed in .gitignore).
# utils/ppm.py runs the same compile on first use when a C++ compiler is
# on PATH, so this script is only needed to build ahead of time.
set -e
cd "$(dirname "$0")"
mkdir -p build
g++ -std=c++17 -O2 -fPIC -shared -o build/libppm_encoder.so ppm_encoder.cc
echo "built: $(pwd)/build/libppm_encoder.so"
