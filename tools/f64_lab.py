#!/usr/bin/env python3
"""What limits the f64 path's kernels (glc_tpu_torch/csrc/f64_rows.cuh) on
the card, measured by variants of the kernel, for a machine where Nsight
Compute cannot profile.

    python3 tools/f64_lab.py PARENT_CHECKOUT [OUT.json]

PARENT_CHECKOUT is another checkout of the repository (the parent commit's,
say, unpacked by `git archive`), whose csrc/f64_rows.cuh is built beside
this one's.  One library is built with nvcc (-Xptxas -v: registers and
spills printed) from:

- the f64 tensor cores' rate from registers: mma.sync m16n8k16 f64 on 8 or
  16 independent accumulators a warp, with 0, 1, 2 or 4 f32 -> f64
  conversions a mma a lane;
- the parent's f64 kernel;
- this checkout's kernel at each build the wrappers launch
  (f64rows::Tile16, Tile32) in three variants (f64rows::Probe): whole,
  with no copies after the ring's first stages (the shared-memory and
  tensor-core path alone) and with no mma (the copies alone);
- other builds of the same kernel (EXTRA: other residencies, block tiles
  and warp counts), whole.

Each runs at n = 441 and 256 on mdct_rows' M = 8192 rows and
imdct_window's B = 2816 rows (seeded inputs), back to back
(`bench.device_ms`), a block a tile; every whole build is checked bit for
bit against the parent's kernel.  Needs one CUDA card; prints one line
per measurement and writes them to OUT.json.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
from glc_tpu_torch.bench import device_ms, seeded_rows  # noqa: E402
from glc_tpu_torch.codec.tables import get_codec_tables  # noqa: E402
from glc_tpu_torch.ops import kernels  # noqa: E402

N_HOPS = (441, 256)
ROWS = {"mdct_rows": 8192, "imdct_window": 2816}
BUILDS = ("Tile16", "Tile32")
VARIANTS = {"whole": "WHOLE", "no loads": "NO_LOADS", "no mma": "NO_MMA"}
# Builds the wrappers do not launch: name -> Config's arguments
EXTRA = {
    "Tile32 5 an SM": "2, 2, 16, 32, 32, 3, 5",
    "Tile64 of 4 warps, 3 an SM": "2, 2, 32, 32, 32, 4, 3",
    "Tile64 of 4 warps, 2 an SM": "2, 2, 32, 32, 32, 4, 2",
    "Tile64 of 8 warps, 2 an SM": "4, 2, 16, 32, 32, 3, 2",
    "Tile128 of 4 warps, 2 an SM": "4, 1, 32, 64, 32, 2, 2",
}
PEAK = 67e12  # the f64 tensor cores, NVIDIA's data sheet (H100 SXM)

EPILOGUES = r"""
struct Scale {
  const float* norm;
  __device__ float operator()(double total, int) const {
    return __double2float_rn(__dmul_rn(total, *norm));
  }
};
struct Window {
  float norm;
  const float* window;
  __device__ float operator()(double total, int t) const {
    return __double2float_rn(__dmul_rn(__dmul_rn(total, norm), window[t]));
  }
};
"""

RATE = r"""
template <int R, int CVT>
__global__ void dmma_rate(int iters, double* sink) {
  double a[8], b[4], acc[R][4];
  float f[8];
  for (int e = 0; e < 8; ++e) { f[e] = 1.0f + threadIdx.x * 1e-3f + e; a[e] = f[e]; }
  for (int e = 0; e < 4; ++e) b[e] = 1.0 / (1 + e + threadIdx.x);
  for (int r = 0; r < R; ++r) for (int h = 0; h < 4; ++h) acc[r][h] = 0;
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
#pragma unroll
      for (int c = 0; c < CVT; ++c) {  // a conversion the mma waits for
        const int e = (r * CVT + c) % 8;
        f[e] = __int_as_float(__float_as_int(f[e]) ^ 1);
        a[e] = static_cast<double>(f[e]);
      }
      f64rows::mma_f64(acc[r], a, b);
    }
  }
  double s = 0;
  for (int r = 0; r < R; ++r) for (int h = 0; h < 4; ++h) s += acc[r][h];
  if (s == 12345.678) sink[0] = s;
}
extern "C" int lab_rate(int r, int cvt, int blocks, int threads, int iters,
                        double* sink, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  if (r == 8 && cvt == 0) dmma_rate<8, 0><<<blocks, threads, 0, st>>>(iters, sink);
  else if (r == 16 && cvt == 0) dmma_rate<16, 0><<<blocks, threads, 0, st>>>(iters, sink);
  else if (r == 8 && cvt == 1) dmma_rate<8, 1><<<blocks, threads, 0, st>>>(iters, sink);
  else if (r == 8 && cvt == 2) dmma_rate<8, 2><<<blocks, threads, 0, st>>>(iters, sink);
  else if (r == 8 && cvt == 4) dmma_rate<8, 4><<<blocks, threads, 0, st>>>(iters, sink);
  else return 1;
  return static_cast<int>(cudaGetLastError());
}
"""

PARENT = r"""
extern "C" int lab_parent(int mdct, const float* a, int lda, const float* b,
                          long long sbj, long long sbk, float* out, int M,
                          int N, int K, const float* normp,
                          const float* window, float norm, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  if (mdct) return f64parent::launch(a, lda, b, sbj, sbk, out, M, N, K, Scale{normp}, st);
  return f64parent::launch(a, lda, b, sbj, sbk, out, M, N, K, Window{norm, window}, st);
}
"""


def configs() -> dict:
    """Each build the lab times: name -> the Config it instantiates."""
    out = {}
    for tile in BUILDS:
        for variant, probe in VARIANTS.items():
            args = ("" if variant == "whole" else
                    f"{tile}::WARPS_M, {tile}::WARPS_N, {tile}::WM, "
                    f"{tile}::WN, {tile}::BK, {tile}::STAGES, "
                    f"{tile}::MIN_BLOCKS, {probe}")
            out[f"{tile} {variant}"] = (f"Config<{args}>" if args else tile)
    for name, args in EXTRA.items():
        out[name] = f"Config<{args}>"
    return out


def build(parent: Path, tmp: Path) -> ctypes.CDLL:
    header = ROOT / "glc_tpu_torch/csrc/f64_rows.cuh"
    cases = "".join(
        f"    case {i}: return run<{cfg}>(args...);\n"
        for i, cfg in enumerate(configs().values()))
    sources = {
        "rate": f'#include "{header}"\n{RATE}',
        # the parent's header under another namespace name
        "parent": f'#define f64rows f64parent\n#include '
                  f'"{parent / "glc_tpu_torch/csrc/f64_rows.cuh"}"\n'
                  f'{EPILOGUES}{PARENT}',
        "this": f'''#include "{header}"
{EPILOGUES}
namespace f64rows {{
template <class C>
int run(int mdct, const float* a, int lda, const float* b, int ldb,
        float* out, int M, int N, int K, const float* normp,
        const float* window, float norm, cudaStream_t st) {{
  if (mdct) return launch<C>(a, lda, b, ldb, out, M, N, K, Scale{{normp}}, st);
  return launch<C>(a, lda, b, ldb, out, M, N, K, Window{{norm, window}}, st);
}}
template <class C>
int run(int* info) {{ return info_of<C, Window>(info); }}
template <typename... Args>
int pick(int id, Args... args) {{
  switch (id) {{
{cases}  }}
  return 1;
}}
}}  // namespace f64rows
extern "C" int lab_run(int id, int mdct, const float* a, int lda,
                       const float* b, int ldb, float* out, int M, int N,
                       int K, const float* normp, const float* window,
                       float norm, void* stream) {{
  return f64rows::pick(id, mdct, a, lda, b, ldb, out, M, N, K, normp, window,
                       norm, static_cast<cudaStream_t>(stream));
}}
extern "C" int lab_info(int id, int* info) {{
  return f64rows::pick(id, info);
}}
'''}
    nvcc = kernels.find_nvcc()
    procs = {}
    for name, text in sources.items():
        (tmp / f"{name}.cu").write_text(text)
        procs[name] = subprocess.Popen(
            [nvcc, *kernels.NVCC_FLAGS, "-Xptxas", "-v", "-c", "-o",
             str(tmp / f"{name}.o"), str(tmp / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    for name, proc in procs.items():
        err = proc.communicate()[1]
        if proc.returncode:
            raise RuntimeError(f"nvcc {name}:\n{err}")
        for line in err.splitlines():
            if "Compiling entry" in line or "Used" in line or "spill" in line:
                print(f"[ptxas {name}] {line.strip()}")
    lib_path = tmp / "lab.so"
    subprocess.run([nvcc, *kernels.NVCC_FLAGS, "-shared", "-o", str(lib_path),
                    *(str(tmp / f"{n}.o") for n in sources)], check=True)
    return ctypes.CDLL(str(lib_path))


def main(argv: list[str]) -> int:
    if not torch.cuda.is_available() or len(argv) not in (1, 2):
        print(__doc__, file=sys.stderr)
        return 1
    parent = Path(argv[0]).resolve()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi)
    results = {"card": smi}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        lib = build(parent, Path(tmp))
        print(f"[build] {time.perf_counter() - t0:.1f} s")
        P, I, F, L = (ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
                      ctypes.c_longlong)
        lib.lab_rate.argtypes = [I, I, I, I, I, P, P]
        lib.lab_parent.argtypes = [I, P, I, P, L, L, P, I, I, I, P, P, F, P]
        lib.lab_run.argtypes = [I, I, P, I, P, I, P, I, I, I, P, P, F, P]
        lib.lab_info.argtypes = [I, P]
        stream = torch.cuda.current_stream().cuda_stream
        sms = torch.cuda.get_device_properties(0).multi_processor_count

        sink = torch.zeros(1, dtype=torch.float64, device="cuda")
        for r, cvt in ((8, 0), (16, 0), (8, 1), (8, 2), (8, 4)):
            blocks, threads, iters = 4 * sms, 256, 2000

            def run():
                return lib.lab_rate(r, cvt, blocks, threads, iters,
                                    sink.data_ptr(), stream)

            if run():
                raise RuntimeError(f"rate R={r} cvt={cvt}: refused")
            ms = device_ms(run, launches=5)
            flops = blocks * threads // 32 * iters * r * 2 * 16 * 8 * 16
            results[f"rate R={r} cvt={cvt}"] = rate = flops / ms / 1e9
            print(f"[rate] mma.sync m16n8k16 f64 from registers, {r} "
                  f"accumulators a warp, {cvt} conversions a mma a lane "
                  f"({smi}): {rate:.2f} TFLOP/s")

        cases = []
        for n in N_HOPS:
            tables = get_codec_tables(n, 2 * n, 44100, "cuda")
            cases += [(n, tables, "mdct_rows",
                       seeded_rows(ROWS["mdct_rows"], 2 * n, 2,
                                   tables.window)),
                      (n, tables, "imdct_window",
                       seeded_rows(ROWS["imdct_window"], n, 1))]
        for n, tables, name, x in cases:
            t_t = tables.cos_table.t().contiguous()
            mdct = name == "mdct_rows"
            M = x.shape[0]
            N, K = (n, 2 * n) if mdct else (2 * n, n)
            table = (kernels.f64_table_t if mdct else kernels.f64_table)(
                tables.cos_table)
            bound = 2.0 * M * N * K / PEAK * 1e3
            want = torch.empty((M, N), device="cuda")

            def parent_run(out=want):
                b, sbj, sbk = ((t_t, 1, n) if mdct
                               else (tables.cos_table, 1, 2 * n))
                return lib.lab_parent(mdct, x.data_ptr(), K, b.data_ptr(),
                                      sbj, sbk, out.data_ptr(), M, N, K,
                                      tables.norm.data_ptr(),
                                      tables.window.data_ptr(),
                                      tables.norm_value, stream)

            if parent_run():
                raise RuntimeError("the parent's kernel was refused")
            ms = device_ms(parent_run)
            results[f"{name} parent"] = ms
            print(f"[lab] {name} n={n} rows={M} ({smi}): the parent's "
                  f"kernel {ms:.4f} ms ({bound / ms:.1%} of the bound "
                  f"{bound:.4f} ms)")
            for i, build_name in enumerate(configs()):
                info = (I * 8)()
                if lib.lab_info(i, info):
                    raise RuntimeError(f"{build_name}: no info")
                out = torch.empty((M, N), device="cuda")

                def run():
                    return lib.lab_run(i, mdct, x.data_ptr(), K,
                                       table.data_ptr(), table.shape[1],
                                       out.data_ptr(), M, N, K,
                                       tables.norm.data_ptr(),
                                       tables.window.data_ptr(),
                                       tables.norm_value, stream)

                if run():
                    raise RuntimeError(f"{build_name}: refused")
                torch.cuda.synchronize()
                bits = ""
                if not build_name.endswith(("no loads", "no mma")):
                    if not torch.equal(out, want):
                        raise AssertionError(f"{name} {build_name}: the "
                                             f"parent's bits differ")
                    bits = ", the parent's bits"
                ms = device_ms(run)
                results[f"{name} {build_name}"] = ms
                print(f"[lab] {name} n={n} rows={M} {build_name} "
                      f"({info[6]} x {info[7]}, {info[0]} regs, "
                      f"{info[1]} B spills, {info[5]} blocks an SM, "
                      f"{kernels.f64_tiles(M, N, info[6], info[7])} tiles): "
                      f"{ms:.4f} ms ({bound / ms:.1%} of the bound){bits}")
    if len(argv) == 2:
        Path(argv[1]).write_text(json.dumps(results))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
