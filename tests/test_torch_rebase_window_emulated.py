"""K9's CUDA source, compiled for the host, against its plain PyTorch form.

``csrc/rebase_window.cu`` cannot be built without ``nvcc``, so this test
compiles the same source with the host C++ compiler against a small header
that runs each thread of a block (384: twelve warps) as a ``std::thread``,
blocks in turn.  Every warp collective (``__shfl*_sync`` with its width,
``__ballot_sync``, ``__any_sync``, ``__syncwarp``) is an exchange fenced by
the warp's own barrier; ``__syncthreads`` and the named per-leg barriers
(``bar.sync``) are barriers of the block and of each leg's threads; the
shared-memory atomics are host atomics.  ``-DRW_EMULATE`` drops the launch
wrapper and makes the asynchronous row staging (``cp.async``) a plain copy
with nothing to wait for.  The emulated kernel must equal
``rebase_window_plain`` on every word of every step row.  It checks the
kernel's logic (the prologue's scans, the ballots, the emission, the pair
step, the staging chunks, the row layout), not its compilation for the card
or its speed: those are ``tests/test_torch_cuda_kernels.py``'s ``cuda``
cases and ``chip_smoke.py``.  Skips where there is no C++20 compiler.
"""

from __future__ import annotations

import ctypes
import re
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from fluidframework_tpu_torch.ops import rebase_kernel as rk9

from test_torch_cuda_kernels import commit_windows, k9_case_id, rebase_windows

SOURCE = Path(rk9.__file__).resolve().parent.parent / "csrc" / "rebase_window.cu"
# the source's entry rows per staging buffer
CHUNK = int(re.search(r"constexpr int CHUNK = (\d+);", SOURCE.read_text()).group(1))

_EMU = r"""
#include <algorithm>
#include <barrier>
#include <memory>
#include <thread>
#include <vector>
using std::max;
using std::min;
struct Dim3 { unsigned x = 0, y = 0, z = 0; };
thread_local Dim3 threadIdx;
Dim3 blockIdx, blockDim;
constexpr int EMU_WARPS = 32;
std::barrier<>* g_warp_bar[EMU_WARPS];  // one per warp of the block
std::barrier<>* g_named_bar[16];        // bar.sync ids (0: the whole block)
int g_xch[EMU_WARPS][2][32];            // per-warp exchange slots, double-buffered
thread_local unsigned t_round;          // this lane's exchange count
#define __global__
#define __device__
#define __forceinline__ inline
#define __shared__ static
#define __restrict__
#define __launch_bounds__(...)
#define __align__(n) alignas(n)
inline int emu_warp() { return threadIdx.x >> 5; }
inline void __syncwarp() { g_warp_bar[emu_warp()]->arrive_and_wait(); }
inline void __syncthreads() { g_named_bar[0]->arrive_and_wait(); }
template <int ID>
inline void leg_sync() { g_named_bar[ID]->arrive_and_wait(); }  // bar.sync ID, LEG
// Every lane of the warp posts v, the warp meets, each lane reads lane src's
// value (its own where `take` is false).  The slots alternate, so the next
// exchange cannot overwrite a slot before every lane has read it.
inline int* post(int v) {
  int* buf = g_xch[emu_warp()][t_round++ & 1];
  buf[threadIdx.x & 31] = v;
  g_warp_bar[emu_warp()]->arrive_and_wait();
  return buf;
}
inline int xchg(int v, int src, bool take) {
  const int* buf = post(v);
  return take ? buf[src & 31] : v;
}
inline int __shfl_sync(unsigned, int v, int src, int width = 32) {
  const int lane = threadIdx.x & 31;
  return xchg(v, (lane & ~(width - 1)) + (src & (width - 1)), true);
}
inline int __shfl_up_sync(unsigned, int v, int d, int width = 32) {
  const int lane = threadIdx.x & 31;
  return xchg(v, lane - d, (lane & (width - 1)) >= d);
}
inline int __shfl_down_sync(unsigned, int v, int d, int width = 32) {
  const int lane = threadIdx.x & 31;
  return xchg(v, lane + d, (lane & (width - 1)) + d < width);
}
inline int __shfl_xor_sync(unsigned, int v, int m, int width = 32) {
  const int lane = threadIdx.x & 31, src = lane ^ m;
  return xchg(v, src, (src & ~(width - 1)) <= (lane & ~(width - 1)));
}
inline unsigned __ballot_sync(unsigned, int p) {
  const int* buf = post(p != 0);
  unsigned r = 0;
  for (int i = 0; i < 32; ++i) r |= (unsigned)buf[i] << i;
  return r;
}
inline bool __any_sync(unsigned m, int p) { return __ballot_sync(m, p) != 0; }
inline int __popc(unsigned v) { return __builtin_popcount(v); }
inline int __ffs(int v) { return __builtin_ffs(v); }
inline int __clz(int v) { return v ? __builtin_clz((unsigned)v) : 32; }
inline int atomicAdd(int* a, int v) { return __atomic_fetch_add(a, v, __ATOMIC_SEQ_CST); }
inline int atomicMax(int* a, int v) {
  int old = __atomic_load_n(a, __ATOMIC_SEQ_CST);
  while (old < v && !__atomic_compare_exchange_n(a, &old, v, false, __ATOMIC_SEQ_CST,
                                                 __ATOMIC_SEQ_CST)) {
  }
  return old;
}
#define RW_EMULATE 1
#include "SOURCE"
// One window per block, its THREADS threads as std::threads, blocks in turn.
extern "C" int emu_rebase_window(const int* c, const int* xs, const unsigned char* elig,
                                 int* final_c, int* steps, int W, int C) {
  std::vector<std::unique_ptr<std::barrier<>>> bars;
  for (int i = 0; i < THREADS / 32; ++i) {
    bars.emplace_back(new std::barrier<>(32));
    g_warp_bar[i] = bars.back().get();
  }
  std::barrier<> block(THREADS), leg0(LEG), leg1(LEG);
  g_named_bar[0] = &block;
  g_named_bar[1] = &leg0;
  g_named_bar[2] = &leg1;
  blockDim.x = THREADS;
  for (int b = 0; b < W; ++b) {
    blockIdx.x = b;
    std::vector<std::thread> threads;
    for (int t = 0; t < THREADS; ++t)
      threads.emplace_back([=] {
        threadIdx.x = t;
        t_round = 0;
        rebase_window_kernel(c, xs, elig, final_c, steps, W, C);
      });
    for (auto& t : threads) t.join();
  }
  return 0;
}
"""


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler to build the emulation")
    d = tmp_path_factory.mktemp("k9_emu")
    src = d / "emu.cpp"
    src.write_text(_EMU.replace("SOURCE", str(SOURCE)))
    lib = d / "libk9emu.so"
    proc = subprocess.run([cxx, "-std=c++20", "-O1", "-shared", "-fPIC", "-o", str(lib),
                           str(src), "-lpthread"], capture_output=True, text=True)
    if proc.returncode != 0 and "barrier" in proc.stderr:
        pytest.skip("the host compiler has no C++20 <barrier>")
    assert proc.returncode == 0, proc.stderr
    fn = ctypes.CDLL(str(lib)).emu_rebase_window
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 2
    return fn


# Random encodings (every field in range; valid and dead steps both occur)
# and pooled commits (every step engages): C past one and two staging
# chunks (the third chunk reuses the first buffer), C not a power of two,
# several windows.
EMULATED_CASES = [
    ("random", 1, 12), ("random", 5, 6), ("random", 9, 3),
    ("random", 2, CHUNK + 1), ("random", 1, 2 * CHUNK + 3), ("random", 3, CHUNK + 5),
    ("insert", 2, 8), ("mixed", 3, CHUNK + 3), ("mixed", 1, 2 * CHUNK + 8),
]


@pytest.mark.parametrize("kind,W,C", EMULATED_CASES, ids=map(k9_case_id, EMULATED_CASES))
def test_emulated_kernel_matches_plain(emulated, kind, W, C):
    if kind == "random":
        c, xs, elig = rebase_windows(7003 + W * 10 + C, W, C)
    else:
        c, xs, elig = commit_windows(W * 1000 + C, W, C, mixed=kind == "mixed")
    want_final, want_steps = rk9.rebase_window_plain(c, xs, elig)
    valid = int(want_steps[..., 0].sum())
    assert 0 < valid < W * C if kind == "random" else valid > W  # dead steps are compared too
    cn, xn, en = (t.numpy().copy() for t in (c, xs, elig))
    final = np.full((W, rk9.ENC_WORDS), -7, np.int32)
    steps = np.full((W, C, rk9.STEP_WORDS), -7, np.int32)
    ptr = lambda a: a.ctypes.data_as(ctypes.c_void_p)
    emulated(ptr(cn), ptr(xn), ptr(en), ptr(final), ptr(steps), W, C)
    assert torch.equal(torch.from_numpy(final), want_final)
    assert torch.equal(torch.from_numpy(steps), want_steps)
