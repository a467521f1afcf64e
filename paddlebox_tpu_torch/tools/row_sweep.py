"""Design sweep of the row kernels 1 and 13 (``csrc/gather_rows.cu``,
``csrc/scatter_add_update.cu``) on the card.

Each variant is the committed source with one design choice changed (a
text substitution below, or, for ``ring``, the cp.async shared-memory
ring of ``csrc/row_dma.cu``'s scatter put in place of the register
pipeline). Every variant builds with the port's ``nvcc`` flags into its
own library, is held exact against the plain version at each shape, and
its C entry is timed alone (the mean of 20 launches, each after a 256 MB
L2 flush by ``zero_``, by CUDA events) in 4 rounds of alternating order
on the same inputs; the median of the 4 prints beside the share of the
bound, with the card's name and power limit.

    python -m paddlebox_tpu_torch.tools.row_sweep [--out chiprun_out/row_sweep.json]
    python -m paddlebox_tpu_torch.tools.row_sweep --emit DIR   # sources only

Shapes: the path's unique-row buckets at the Adagrad, Adam and shared-Adam
widths 16, 37 and 23 (481 187 rows of 524 288, a 2^23-row table) and at
the multi-mf class widths 12 and 24 (185 557 of 196 608 and 110 530 of
131 072 rows, 2^21-row tables), random distinct rows from a seed.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Callable, Dict, Tuple

from paddlebox_tpu_torch.ops import _build

PEAK_BYTES = 3.35e12      # H100 SXM HBM3 bytes/s (NVIDIA data sheet)
#: (row floats, table rows, real rows, padded rows)
SHAPES = ((37, 1 << 23, 481187, 524288), (23, 1 << 23, 481187, 524288),
          (16, 1 << 23, 481187, 524288), (12, 1 << 21, 185557, 196608),
          (24, 1 << 21, 110530, 131072))

_GRID_ALL = ("rowwalk::grid(u, kThreads, resident)",
             "rowwalk::grid(u, kThreads, 1LL << 40)")
_GATHER = {
    "kernel": (),
    "groups_64_bytes": (("constexpr int G = 128 /", "constexpr int G = 64 /"),),
    "groups_256_bytes": (("constexpr int G = 128 /",
                          "constexpr int G = 256 /"),),
    "threads_128": (("constexpr int kThreads = 256;",
                     "constexpr int kThreads = 128;"),),
    "threads_512": (("constexpr int kThreads = 256;",
                     "constexpr int kThreads = 512;"),),
    "one_warp_a_chunk": (_GRID_ALL,),
}
_SCATTER = {
    "kernel": (),
    "groups_32_bytes": (("constexpr int G = 64 /", "constexpr int G = 32 /"),),
    "groups_96_bytes": (("constexpr int G = 64 /", "constexpr int G = 96 /"),),
    "threads_128": (("constexpr int kThreads = 256;",
                     "constexpr int kThreads = 128;"),),
    "threads_512": (("constexpr int kThreads = 256;",
                     "constexpr int kThreads = 512;"),),
    "one_warp_a_chunk": (_GRID_ALL,),
    # the stores walk the units again, a shuffle each, instead of keeping
    # each unit's table offset from its load
    "rewalk_for_stores": (
        ("      long long off[G];   // each unit's table offset, -1 to skip\n",
         "      Walk st = at;\n"),
        ("          off[k] = dst >= 0 ? static_cast<long long>(dst) * w + "
         "at.c : -1;\n          if (dst >= 0) {\n            a[k] = "
         "values[off[k]];",
         "          if (dst >= 0) {\n            a[k] = values["
         "static_cast<long long>(dst) * w + at.c];"),
        ("        if (j0 + k < w && off[k] >= 0) values[off[k]] = "
         "add(a[k], b[k]);",
         "        if (j0 + k < w) {\n          const int dst = __shfl_sync("
         "0xffffffffu, id, st.r);\n          if (dst >= 0) {\n"
         "            values[static_cast<long long>(dst) * w + st.c] =\n"
         "                add(a[k], b[k]);\n          }\n"
         "          st.next();\n        }"),
    ),
}

# The cp.async ring: a group's table and delta units land in a two-deep
# shared-memory ring (a slot a lane) while the previous group adds and
# stores; 128 threads a block, 16 floats or 4 vectors a group (32 KB).
_RING = r"""
constexpr int kRingThreads = 128;

__device__ __forceinline__ void cp_async(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem) : "memory");
}
__device__ __forceinline__ void cp_async(float4* smem, const float4* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem) : "memory");
}

struct Group {
  int id, j0;
  Walk at;
};

template <typename T, int G>
__global__ void __launch_bounds__(kRingThreads)
scatter_add_ring(T* __restrict__ values, const int* __restrict__ rows,
                 const T* __restrict__ deltas, long long u, int w, int c) {
  __shared__ T ring[2][2][G][kRingThreads];
  const int lane = threadIdx.x & 31;
  const int t = threadIdx.x;
  const long long n_chunks = (u + 31) >> 5;
  const long long stride =
      static_cast<long long>(gridDim.x) * (kRingThreads / 32);
  long long ch =
      (static_cast<long long>(blockIdx.x) * kRingThreads + threadIdx.x) >> 5;
  const Walk start(w);
  auto finish = [&](const Group& p, int b) {
    Walk st = p.at;
#pragma unroll
    for (int k = 0; k < G; ++k) {
      if (p.j0 + k < w) {
        const int dst = __shfl_sync(0xffffffffu, p.id, st.r);
        if (dst >= 0) {
          values[static_cast<long long>(dst) * w + st.c] =
              add(ring[b][0][k][t], ring[b][1][k][t]);
        }
        st.next();
      }
    }
  };
  int next = ch < n_chunks ? chunk_id(rows, ch, u, c) : -1;
  Group prev{-1, 0, start};
  bool have = false;
  int buf = 0;
  for (; ch < n_chunks; ch += stride) {
    const int id = next;
    next = ch + stride < n_chunks ? chunk_id(rows, ch + stride, u, c) : -1;
    const T* d = deltas + (ch << 5) * w;
    Walk at = start;
    for (int j0 = 0; j0 < w; j0 += G) {
      const Group cur{id, j0, at};
#pragma unroll
      for (int k = 0; k < G; ++k) {
        if (j0 + k < w) {
          const int dst = __shfl_sync(0xffffffffu, id, at.r);
          if (dst >= 0) {
            cp_async(&ring[buf][0][k][t],
                     values + static_cast<long long>(dst) * w + at.c);
            cp_async(&ring[buf][1][k][t], d + lane + 32 * (j0 + k));
          }
          at.next();
        }
      }
      asm volatile("cp.async.commit_group;\n" ::: "memory");
      if (have) {
        asm volatile("cp.async.wait_group 1;\n" ::: "memory");
        finish(prev, buf ^ 1);
      }
      prev = cur;
      have = true;
      buf ^= 1;
    }
  }
  if (have) {
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    finish(prev, buf ^ 1);
  }
}

template <typename T>
int launch_ring(float* values, const int* rows, const float* deltas,
                long long u, int c, int w, cudaStream_t s) {
  constexpr int G = 64 / static_cast<int>(sizeof(T));
  int rc = 0;
  const long long resident = rowwalk::resident_blocks(
      scatter_add_ring<T, G>, kRingThreads, &rc);
  if (rc != 0) return rc;
  const unsigned g = rowwalk::grid(u, kRingThreads, resident);
  scatter_add_ring<T, G><<<g, kRingThreads, 0, s>>>(
      reinterpret_cast<T*>(values), rows,
      reinterpret_cast<const T*>(deltas), u, w, c);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
"""
_SCATTER["ring"] = (
    ("}  // namespace\n", _RING),
    ("? launch<float4>(values", "? launch_ring<float4>(values"),
    (": launch<float>(values", ": launch_ring<float>(values"),
)


def variants() -> Dict[str, Tuple[str, str]]:
    """name → (kernel library, source text) of every variant; raises
    when a substitution no longer finds its text in the source."""
    out = {}
    for lib, subs in (("gather_rows", _GATHER),
                      ("scatter_add_update", _SCATTER)):
        text = (_build.CSRC / f"{lib}.cu").read_text()
        for name, pairs in subs.items():
            src = text
            for old, new in pairs:
                if old not in src:
                    raise ValueError(f"{lib} {name}: {old!r} is not in the "
                                     f"source")
                src = src.replace(old, new, 1)
            out[f"{lib}.{name}"] = (lib, src)
    return out


def emit(directory: str) -> Dict[str, str]:
    """Write each variant's source into ``directory``; name → path."""
    os.makedirs(directory, exist_ok=True)
    paths = {}
    for name, (_, src) in variants().items():
        paths[name] = os.path.join(directory, f"{name}.cu")
        Path(paths[name]).write_text(src)
    return paths


def _time_ms(torch, fn: Callable, flush, iters: int = 20) -> float:
    for _ in range(3):
        fn()
    total = 0.0
    for _ in range(iters):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / iters


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default="chiprun_out/row_sweep.json")
    ap.add_argument("--emit", default=None,
                    help="write the variant sources here and stop")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if args.emit:
        for name, path in emit(args.emit).items():
            print(name, path)
        return 0
    import torch
    from paddlebox_tpu_torch.ops import kernels as K
    if not torch.cuda.is_available():
        print("row_sweep: no CUDA device")
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    build = _build.BUILD_DIR / "sweep"
    paths = emit(str(build))

    def compile_one(name):
        so = str(build / f"{name}.so")
        proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I",
                               str(_build.CSRC), "-o", so, paths[name]],
                              capture_output=True, text=True)
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{proc.stderr}")
        regs = [ln.split("Used")[1].split(",")[0].strip()
                for ln in (proc.stdout + proc.stderr).splitlines()
                if "Used" in ln]
        return name, so, regs

    with ThreadPoolExecutor(len(paths)) as ex:
        built = list(ex.map(compile_one, paths))
    fns = {}
    for name, so, regs in built:
        lib = name.split(".")[0]
        fn = getattr(ctypes.CDLL(so), f"pbx_{lib}")
        fn.argtypes = (K._GATHER_ARGS if lib == "gather_rows"
                       else K._SCATTER_ADD_ARGS)
        fn.restype = ctypes.c_int
        fns[name] = fn
        print(f"built {name}: {', '.join(regs)}", flush=True)
    flush = torch.empty(64 << 20, device="cuda")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(args.seed)
    stream = torch.cuda.current_stream().cuda_stream
    result = {"card": card, "shapes": {}}
    for f, c, real, pad in SHAPES:
        table = torch.randn((c + 1, f), generator=gen, device="cuda")
        rows = torch.cat([torch.randperm(c, generator=gen,
                                         device="cuda")[:real],
                          c + 1 + torch.arange(pad - real, device="cuda")]
                         ).int()
        deltas = torch.randn((pad, f), generator=gen, device="cuda") * 1e-3
        out = torch.empty((pad, f), device="cuda")
        vals = table[:c].clone()
        vec = 4 if K._vec4(f, table, out) else 1
        bounds = {"gather_rows": 2 * real * f * 4 + pad * 4,
                  "scatter_add_update": pad * 4 + real * 3 * f * 4}
        want_g = K.gather_rows_plain(table, rows)
        want_s = K.scatter_add_update_plain(table[:c].clone(), rows, deltas)
        calls = {}
        for name, fn in fns.items():
            if name.startswith("gather_rows"):
                def call(fn=fn):
                    _build.check(fn(table.data_ptr(), rows.data_ptr(),
                                    out.data_ptr(), pad, c, f, vec, stream),
                                 "gather_rows")
                out.fill_(float("nan"))
                call()
                torch.cuda.synchronize()
                ok = torch.equal(out, want_g)
            else:
                def call(fn=fn):
                    _build.check(fn(vals.data_ptr(), rows.data_ptr(),
                                    deltas.data_ptr(), pad, c, f, vec,
                                    stream), "scatter_add_update")
                vals.copy_(table[:c])
                call()
                torch.cuda.synchronize()
                ok = torch.equal(vals, want_s)
            if not ok:
                raise AssertionError(f"{name} at width {f} differs from "
                                     f"the plain version")
            calls[name] = call
        runs = {n: [] for n in calls}
        names = list(calls)
        for r in range(4):
            for n in names if r % 2 == 0 else names[::-1]:
                runs[n].append(_time_ms(torch, calls[n], flush))
        med = {n: sorted(v)[1:3] for n, v in runs.items()}
        shape = {}
        for n, (a, b) in med.items():
            ms = (a + b) / 2
            bound = bounds[n.split(".")[0]] / PEAK_BYTES * 1e3
            shape[n] = {"ms": ms, "runs": runs[n], "of_bound": bound / ms}
        result["shapes"][f"{f}x{c}"] = shape
        print(f"width {f}, U {pad} ({real} real), table {c} rows: " + "; ".join(
            f"{n} {v['ms']:.4f} ms ({v['of_bound']:.1%})"
            for n, v in shape.items()) + f" ({card})", flush=True)
        del table, rows, deltas, out, vals, want_g, want_s
        torch.cuda.empty_cache()
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as fh:
        json.dump(result, fh, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
