"""K9's CUDA source, compiled for the host, against its plain PyTorch form.

``csrc/rebase_window.cu`` cannot be built without ``nvcc``, so this test
compiles the same source with the host C++ compiler (``-DRW_EMULATE`` drops
the launch wrapper) against a small header that runs each lane of the warp
as a ``std::thread`` and makes every warp collective (``__shfl*_sync``,
``__ballot_sync``, ``__any_sync``, ``__syncwarp``) a barrier-fenced
exchange.  The emulated kernel must equal ``rebase_window_plain`` on every
word of every step row.  It checks the kernel's logic (scans, searches,
the pair step, the row layout), not its compilation for the card or its
speed: those are ``tests/test_torch_cuda_kernels.py``'s ``cuda`` cases and
``chip_smoke.py``.  Skips where there is no C++20 compiler.
"""

from __future__ import annotations

import ctypes
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from fluidframework_tpu_torch.ops import rebase_kernel as rk9

from test_torch_cuda_kernels import rebase_windows

SOURCE = Path(rk9.__file__).resolve().parent.parent / "csrc" / "rebase_window.cu"

_EMU = r"""
#include <algorithm>
#include <barrier>
#include <thread>
#include <vector>
using std::max;
using std::min;
struct Dim3 { unsigned x = 0, y = 0, z = 0; };
thread_local Dim3 threadIdx;
Dim3 blockIdx, blockDim;
std::barrier<>* g_bar;
int g_xch[32];
#define __global__
#define __device__
#define __forceinline__ inline
#define __shared__ static
#define __restrict__
inline void __syncwarp() { g_bar->arrive_and_wait(); }
inline int xchg(int v, int src, bool take) {
  const int lane = threadIdx.x & 31;
  g_bar->arrive_and_wait();
  g_xch[lane] = v;
  g_bar->arrive_and_wait();
  const int r = take ? g_xch[src] : v;
  g_bar->arrive_and_wait();
  return r;
}
inline int __shfl_sync(unsigned, int v, int src) { return xchg(v, src & 31, true); }
inline int __shfl_up_sync(unsigned, int v, int d) {
  const int l = threadIdx.x & 31;
  return xchg(v, l - d, l >= d);
}
inline int __shfl_down_sync(unsigned, int v, int d) {
  const int l = threadIdx.x & 31;
  return xchg(v, l + d, l + d < 32);
}
inline unsigned __ballot_sync(unsigned, int p) {
  const int lane = threadIdx.x & 31;
  g_bar->arrive_and_wait();
  g_xch[lane] = p != 0;
  g_bar->arrive_and_wait();
  unsigned r = 0;
  for (int i = 0; i < 32; ++i) r |= (unsigned)g_xch[i] << i;
  g_bar->arrive_and_wait();
  return r;
}
inline bool __any_sync(unsigned m, int p) { return __ballot_sync(m, p) != 0; }
inline int __popc(unsigned v) { return __builtin_popcount(v); }
#define RW_EMULATE 1
#include "SOURCE"
// One window per block, its 32 lanes as threads, blocks in turn.
extern "C" int emu_rebase_window(const int* c, const int* xs, const unsigned char* elig,
                                 int* final_c, int* steps, int W, int C) {
  std::barrier<> bar(32);
  g_bar = &bar;
  blockDim.x = 32;
  for (int b = 0; b < W; ++b) {
    blockIdx.x = b;
    std::vector<std::thread> lanes;
    for (int l = 0; l < 32; ++l)
      lanes.emplace_back([=] {
        threadIdx.x = l;
        rebase_window_kernel(c, xs, elig, final_c, steps, W, C);
      });
    for (auto& t : lanes) t.join();
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


@pytest.mark.parametrize("W,C", [(1, 12), (5, 6), (9, 3)])
def test_emulated_kernel_matches_plain(emulated, W, C):
    c, xs, elig = rebase_windows(7003 + W * 10 + C, W, C)
    want_final, want_steps = rk9.rebase_window_plain(c, xs, elig)
    assert 0 < int(want_steps[..., 0].sum()) < W * C  # valid and dead steps both occur
    cn, xn, en = (t.numpy().copy() for t in (c, xs, elig))
    final = np.full((W, rk9.ENC_WORDS), -7, np.int32)
    steps = np.full((W, C, rk9.STEP_WORDS), -7, np.int32)
    ptr = lambda a: a.ctypes.data_as(ctypes.c_void_p)
    emulated(ptr(cn), ptr(xn), ptr(en), ptr(final), ptr(steps), W, C)
    assert torch.equal(torch.from_numpy(final), want_final)
    assert torch.equal(torch.from_numpy(steps), want_steps)
