#!/bin/sh
# Build the native host runtime (thread pool + BMP encoder) into
# native/build/libpt_native.so. Requires only g++; takes ~2s. The library
# is written under a temporary name and renamed into place, so concurrent
# builds (one per test worker) never expose a half-written file.
set -e
cd "$(dirname "$0")"
mkdir -p build
tmp="build/libpt_native.so.$$"
g++ -O3 -std=c++17 -fPIC -shared -pthread -o "$tmp" src/pt_native.cpp
mv -f "$tmp" build/libpt_native.so
echo "built $(pwd)/build/libpt_native.so"
