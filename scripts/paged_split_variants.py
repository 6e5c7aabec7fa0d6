"""Time edited variants of bf16 paged_attention's split loop on one NVIDIA GPU.

    python3 scripts/paged_split_variants.py

Each variant is the CUDA source of ``src/repro_torch/kernels/csrc`` with
edits to ``paged_attention.cu`` (text substitutions in a copy, built with
the flags of ``kernels/build.py``, as ``scripts/flash_wgmma_variants.py``
builds its variants), so each line says what one design choice of the
split loop is worth on this card:

- ``pdl_merge``: no cluster; each block writes its (m, l, Σ p·v) to a
  global buffer and a second kernel, launched as a programmatic dependent
  (the chunk loop's ``launch_dependent``), merges the ranks in order;
- ``stages_3``: a 3-stage K/V ring at every head dim (as built: 4 at
  D <= 64, else 2);
- ``stages_4``: 4 stages up to D = 128 (2 past it);
- ``split_N``: the library as built, launched with N blocks a cluster in
  place of ``paged_attention.split_plan``'s count.

Each runs bf16 paged_attention at chip_smoke's phase 3 shapes (qwen3-0.6b
at the 2048-token table's lengths and the engine's; llama-7b, qwen2-vl-7b,
stablelm-12b and gemma-2b at the engine's lengths; pages of 128) and
prints per case its device ms (CUDA events, chip_smoke's timer), its largest error
against the plain bf16 version and whether it keeps chip_smoke's bars.
"as built" runs first and last, to show the drift of the card. Needs a
card and nvcc; prints the card's ``nvidia-smi`` name and power limit first.
"""

from __future__ import annotations

import json
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT), str(ROOT / "scripts")]

import chip_smoke as cs  # noqa: E402
from attention_variants import build_variants, load  # noqa: E402
from repro_torch.kernels import build, ref  # noqa: E402
from repro_torch.kernels.paged_attention import _SIGNATURES, split_plan  # noqa: E402

F = "paged_attention.cu"
SRC = (build.CSRC / F).read_text()
MERGE_FROM = "  cluster.sync();  // every block's (m, l, Σ p·v) is in its shared memory\n"
MERGE_TO = "  cluster.sync();  // no block leaves while another may still read its states\n}\n"
MERGE = SRC[SRC.index(MERGE_FROM):SRC.index(MERGE_TO) + len(MERGE_TO)]
# the states to a global buffer, then a dependent kernel merges them
PDL_STORE = """  __syncthreads();  // the consumers' states are in res and ml
  {  // variant: the states to g_part, merged by a dependent kernel
    float* mine = g_part + ((size_t)blockIdx.y * gridDim.x + s) * (GP * (QLD + 2));
    for (int e = tid; e < GP * QLD; e += THREADS) mine[e] = res[e];
    if (tid < 2 * GP) mine[GP * QLD + tid] = ml[tid];  // m [GP], l [GP]
  }
  __syncthreads();
  grid_dependents_launch();
}
"""
ONE_BLOCK = "// One block: share s = blockIdx.x of (b, kv head) = blockIdx.y."
PDL_BUFFER = "__device__ float g_part[1 << 22];  // the variant's states\n\n" + ONE_BLOCK
PDL_KERNEL = """template <int GP>
__global__ void __launch_bounds__(256) split_merge_kernel(
    const int* __restrict__ lengths, bf16* __restrict__ out, int Hkv, int G, int D, int QLD,
    int ns, int T) {
  grid_dependency_wait();
  const int pair = blockIdx.x, b = pair / Hkv, hkv = pair % Hkv, NC = D / 8;
  const int len = min(max(lengths[b], 0), T);
  const size_t blk = (size_t)GP * (QLD + 2);
  for (int unit = threadIdx.x; unit < G * NC; unit += 256) {
    const int g = unit / NC, c = unit % NC;
    float M = NEG_INF;
    for (int r = 0; r < ns; ++r) M = fmaxf(M, g_part[(pair * ns + r) * blk + GP * QLD + g]);
    float L = 0.f, a[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    for (int r = 0; r < ns; ++r) {
      const float* st = g_part + (pair * ns + r) * blk;
      const float w = expf(st[GP * QLD + g] - M);
      L = fmaf(st[GP * QLD + GP + g], w, L);
      for (int e = 0; e < 8; ++e) a[e] = fmaf(st[g * QLD + 8 * c + e], w, a[e]);
    }
    const float inv = len > 0 ? 1.f / fmaxf(L, 1e-30f) : 0.f;
    *reinterpret_cast<uint4*>(out + ((size_t)b * Hkv * G + hkv * G + g) * D + 8 * c) =
        make_uint4(pack_bf16(a[0] * inv, a[1] * inv), pack_bf16(a[2] * inv, a[3] * inv),
                   pack_bf16(a[4] * inv, a[5] * inv), pack_bf16(a[6] * inv, a[7] * inv));
  }
}

int gcd(int a, int b) {"""
LAUNCH = """  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, paged_attention_split_kernel<DC, GP>, kmap, vmap, q, tables,
                         lengths, out, Hkv, H / Hkv, D, page_size, pages_per_seq, bt);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();"""
PDL_LAUNCH = """  cfg.numAttrs = 0;
  e = cudaLaunchKernelEx(&cfg, paged_attention_split_kernel<DC, GP>, kmap, vmap, q, tables,
                         lengths, out, Hkv, H / Hkv, D, page_size, pages_per_seq, bt);
  if (e != cudaSuccess) return (int)e;
  e = launch_dependent(split_merge_kernel<GP>, dim3(B * Hkv), dim3(256), 0, stream, lengths, out,
                       Hkv, H / Hkv, D, ld<DC>(), n_split, pages_per_seq * page_size);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();"""
STAGES = "__host__ __device__ constexpr int stages() { return DC == 1 ? 4 : 2; }"
# name -> [(file, text, replacement), ...]; each text must occur in its file
VARIANTS = {
    "as built": [],
    "pdl_merge": [(F, ONE_BLOCK, PDL_BUFFER), (F, MERGE, PDL_STORE),
                  (F, "int gcd(int a, int b) {", PDL_KERNEL), (F, LAUNCH, PDL_LAUNCH)],
    "stages_3": [(F, STAGES, "__host__ __device__ constexpr int stages() { return 3; }")],
    "stages_4": [(F, STAGES,
                  "__host__ __device__ constexpr int stages() { return DC <= 2 ? 4 : 2; }")],
}
SPLITS = (1, 2, 3, 4, 6, 8)
# case -> (lengths, H, Hkv, D): chip_smoke.paged_case's shapes, B = 8, T = 2048
CASES = {"qwen3-0.6b table": (cs.PAGED_LENGTHS["table"], 16, 8, 128),
         "qwen3-0.6b engine": (cs.PAGED_LENGTHS["engine"], 16, 8, 128)}
CASES.update({f"{arch} engine": (cs.PAGED_LENGTHS["engine"], H, Hkv, D)
              for arch, H, Hkv, D in cs.ARCH_HEADS[:4]})


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("paged_split_variants: no CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip(), flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    B, T, ps = 8, 2048, 128
    pages = T // ps
    inputs = {}
    for case, (lens, H, Hkv, D) in CASES.items():
        q = torch.randn((B, H, D), generator=gen, device=dev).to(torch.bfloat16)
        kp, vp = (torch.randn((B * pages, ps, Hkv, D), generator=gen, device=dev)
                  .to(torch.bfloat16) for _ in range(2))
        tables = torch.arange(B * pages, dtype=torch.int32, device=dev).view(B, pages)
        ln = torch.tensor(lens, dtype=torch.int32, device=dev)
        want = ref.paged_attention_ref(q, kp, vp, tables, ln)
        want32 = ref.paged_attention_ref(q.float(), kp.float(), vp.float(), tables, ln)
        inputs[case] = (q, kp, vp, tables, ln, want, want32)
    libs = {}
    with tempfile.TemporaryDirectory() as tmp:
        try:  # all in parallel; if one fails, one by one, and the others run
            libs = {n: d["paged_attention"] for n, d in
                    build_variants(Path(tmp) / "all", VARIANTS, ("paged_attention",)).items()}
        except SystemExit:
            for i, (name, edits) in enumerate(VARIANTS.items()):
                try:
                    libs[name] = build_variants(Path(tmp) / f"b{i}", {name: edits},
                                                ("paged_attention",))[name]["paged_attention"]
                except SystemExit as e:
                    print(json.dumps({"variant": name, "build_failed": str(e)[-2000:]}),
                          flush=True)
        runs = [(n, None) for n in VARIANTS if n in libs]
        runs += [(f"split_{n}", n) for n in SPLITS] + [("as built", None)]
        for name, forced in runs:
            lib = load(libs[name if forced is None else "as built"], _SIGNATURES)
            line = {"variant": name}
            for case, (q, kp, vp, tables, ln, want, want32) in inputs.items():
                H, D, Hkv = q.shape[1], q.shape[2], kp.shape[2]
                n_split = forced or split_plan(B, Hkv, sms)
                out = torch.empty_like(q)

                def paged():
                    assert lib.paged_attention_bf16_split_launch(
                        q.data_ptr(), kp.data_ptr(), vp.data_ptr(), tables.data_ptr(),
                        ln.data_ptr(), out.data_ptr(), None, B, H, Hkv, D, ps, pages, kp.shape[0],
                        n_split, stream) == 0

                paged()
                torch.cuda.synchronize()
                err = float((out.float() - want.float()).abs().max())
                atol = cs.ATTN_TOL + cs.BF16_SPLIT_REL * float(want32.abs().max())
                keeps = (err <= cs.BF16_TOL * float(want.float().abs().max())
                         and cs.one_rounding_err(out, want32, atol) <= 0)
                line[case] = {"n_split": n_split, "ms": cs.time_ms(paged)[0],
                              "max_abs_err": err, "keeps_bars": keeps}
            print(json.dumps(line), flush=True)


if __name__ == "__main__":
    main()
