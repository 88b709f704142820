"""Time flash attention (K2) on the card, against
``scaled_dot_product_attention`` and the bound, at the LM paths' prefill
shapes (minicpm3-4b's and deepseek-v2-lite-16b's: MLA's latent, D = 288
and 576, one KV head, v is k), and against other builds of the kernel.

    PYTHONPATH=src python3 -m repro_torch.kernels.flash_attention.bench [DIR ...]

Each DIR holds an edited copy of this kernel's ``csrc/`` directory (a
variant, named by DIR, or by its parent when DIR is called ``csrc``; for
example under ``build/dev/``, which ``.gitignore`` lists). It is
built beside the port's own kernel and timed in turns with it (every
build, then every build again in reverse order), so that versions are
compared within one run on one card. Prints each build's ptxas report for
the bf16 kernels (registers, spills, wgmma serialization remarks), the
card's name and power limit, the port's kernel checked against
``mha_reference`` in bfloat16 (tolerance 2e-2), and at D = 288 and 576
with MLA's ``sm_scale`` also in float32 (2e-3), with v its own tensor, the
zero-padded latent or k itself (the variants are timed, not checked),
and one line per shape with the SDPA backend PyTorch picked. Needs a CUDA
device.
"""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

BF16_TOL = 2e-2
H100_BF16_FLOPS = 989e12        # dense bf16 tensor cores, SXM, 700 W
H100_BYTES_PER_S = 3.35e12
# (B, Hq, Hkv, Sq, Skv, D, causal, q_offset): every head dim, GQA, ragged
# lengths, q_offset, non-causal, and both prefill shapes.
CHECKS = [(1, 1, 1, 128, 128, 64, True, 0), (1, 1, 1, 128, 128, 128, False, 0),
          (1, 2, 2, 256, 256, 112, True, 0), (2, 4, 2, 200, 200, 16, True, 0),
          (2, 2, 2, 256, 256, 32, False, 0), (1, 2, 2, 128, 256, 64, True, 128),
          (1, 4, 2, 333, 333, 96, True, 0), (1, 16, 8, 1000, 1000, 128, True, 0),
          (2, 4, 4, 200, 200, 112, False, 0), (1, 2, 2, 70, 70, 128, True, 0),
          (4, 16, 8, 1819, 1819, 128, True, 0), (4, 32, 32, 1819, 1819, 112, True, 0)]
F32_TOL = 2e-3
# Non-causal attention over thousands of keys averages near-zero values:
# with q, k, v ~ N(0, 1) an output is ~N(0, e / Skv), so FLASH_TOL's 2e-2
# is as large as the outputs themselves. Such checks also hold the error to
# the outputs' scale (``scaled_errors``): (largest error / largest |want|,
# mean error / mean |want|) at most these, by type: twice the largest
# reading of the non-causal card cases of tests/test_torch_encdec.py on an
# H100 (float32 3.56e-6, 1.50e-6; bfloat16 4.83e-3, 1.56e-3). A softmax that
# lets a ragged tail's zero keys in reads ~2e-2 in both in bfloat16.
SCALED_TOL = {"float32": (7e-6, 2.9e-6), "bfloat16": (9.6e-3, 3.1e-3)}
# MLA's latent head dims: D -> (kv_lora_rank, sm_scale = (qk_nope_dim +
# qk_rope_dim) ** -0.5, not D ** -0.5): minicpm3-4b's 256 + 32 and
# deepseek-v2-lite-16b's 512 + 64.
LATENTS = {288: (256, (64 + 32) ** -0.5), 576: (512, (128 + 64) ** -0.5)}
# MLA's latent attention (B, Hq, Sq, Skv, causal, q_offset, v, D), Hkv = 1:
# v "own" (a tensor of its own), "padded" (k's first kv_lora_rank columns,
# zero-padded, as the reference builds it) or "k" (k itself, as the port's
# MLA passes it); each model's prefill shape, a ragged Sq with q_offset,
# non-causal.
MLA_CHECKS = [(4, 40, 1819, 1819, True, 0, v, 288) for v in ("own", "padded", "k")] + \
             [(2, 8, 333, 333, True, 0, "k", 288), (1, 4, 77, 333, True, 256, "k", 288),
              (1, 4, 100, 611, True, 511, "padded", 288), (2, 4, 200, 512, False, 0, "k", 288),
              (1, 3, 300, 256, False, 0, "own", 288)] + \
             [(4, 16, 1819, 1819, True, 0, v, 576) for v in ("own", "padded", "k")] + \
             [(1, 4, 77, 333, True, 256, "k", 576), (1, 4, 100, 611, True, 511, "padded", 576),
              (2, 4, 200, 512, False, 0, "k", 576), (1, 3, 300, 256, False, 0, "own", 576)]
# (B, Hq, Hkv, S, D), causal: qwen3-1.7b's, zamba2-7b's, minicpm3-4b's and
# deepseek-v2-lite-16b's prefill waves, and 2,048 heads of one 128-key tile
# each (a CTA's fixed cost).
SHAPES = [(4, 16, 8, 1819, 128), (4, 32, 32, 1819, 112), (4, 40, 1, 1819, 288),
          (4, 16, 1, 1819, 576), (4, 16, 8, 985, 128), (1, 2048, 2048, 128, 128)]


def scaled_errors(got, want) -> tuple:
    """(max |got - want| / max |want|, mean |got - want| / mean |want|) in
    float32: a softmax denominator off by 3% reads 3e-2 in both, a key
    tile left out reads tenths in the second."""
    diff = (got.float() - want.float()).abs()
    mag = want.float().abs()
    return (diff.max() / mag.max()).item(), (diff.mean() / mag.mean()).item()


def _time_ms(torch, fn, reps: int = 20) -> float:
    """Median milliseconds of ``fn`` by CUDA events, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return sorted(times)[len(times) // 2]


def inputs(torch, b, hq, hkv, sq, skv, d, seed, dtype=None, v_mode="own"):
    """q, k, v ~ N(0, 1) in bf16 (or ``dtype``) on the card; v as MLA_CHECKS
    says ("own", "padded", or "k": v is k)."""
    gen = torch.Generator().manual_seed(seed)
    dt = dtype or torch.bfloat16
    q, k, v = (torch.randn(*s, generator=gen).to("cuda", dt)
               for s in ((b, hq, sq, d), (b, hkv, skv, d), (b, hkv, skv, d)))
    if v_mode == "k":
        v = k
    elif v_mode == "padded":
        rank = LATENTS[d][0]
        v = torch.nn.functional.pad(k[..., :rank], (0, d - rank))
    return q, k, v


def bound_ms(b, hq, hkv, s, d, elem_bytes=2, *, skv=None, causal=True) -> tuple:
    """Least time for attention at q_offset 0 on an H100, s queries over
    ``skv`` keys (s by default), causal or not: the products of the
    visible (query, key) pairs (q.k and p.v, 2 flops each per dimension)
    over the dense bf16 tensor-core peak, against q, k, v read once and o
    written once over the memory rate (v counted apart from k). Returns
    (ms, "operations" | "bytes")."""
    skv = s if skv is None else skv
    pairs = s * (s + 1) // 2 if causal else s * skv
    flops = 4 * b * hq * d * pairs
    nbytes = (2 * b * hq * s * d + 2 * b * hkv * skv * d) * elem_bytes
    t_ops, t_bytes = flops / H100_BF16_FLOPS * 1e3, nbytes / H100_BYTES_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def sdpa_backend(torch, call) -> str:
    """The backend ``scaled_dot_product_attention`` picks for ``call``: the
    first in PyTorch's priority order that runs it (each tried alone)."""
    import warnings

    from torch.nn.attention import SDPBackend, sdpa_kernel

    members = {int(b): b for name, b in SDPBackend.__members__.items()
               if name not in ("ERROR", "OVERRIDEABLE")}
    order = getattr(torch._C, "_get_sdp_priority_order", lambda: [1, 2, 0, 3])()
    for i in order:
        if i not in members:
            continue
        try:
            with warnings.catch_warnings(), sdpa_kernel(members[i]):
                warnings.simplefilter("ignore")
                call()
            torch.cuda.synchronize()
            return members[i].name
        except RuntimeError:
            continue
    return "none"


def _ptxas_report(name: str, log: str) -> None:
    keep = False
    for line in log.splitlines():
        if "Compiling entry" in line:
            keep = "flash_kernel" in line
            if keep:
                print(f"[ptxas {name}] {line.split('flash_kernel')[1][:24]}", flush=True)
        elif keep and ("registers" in line or "spill" in line):
            print(f"[ptxas {name}]   {line.strip()}", flush=True)
        if "C75" in line or "error" in line:
            print(f"[ptxas {name}] {line.strip()[:400]}", flush=True)


def main(argv: list[str]) -> int:
    import torch

    from repro_torch.kernels.build import CudaLibrary, build_all
    from repro_torch.kernels.flash_attention import ops, ref

    if not torch.cuda.is_available():
        print("flash_attention.bench: needs a CUDA device", file=sys.stderr)
        return 1
    builds = {"port": ops.LIBRARY}
    for arg in argv:
        d = Path(arg)
        name = d.parent.name if d.name == "csrc" else d.name
        builds[name] = CudaLibrary(f"flash_{name}", d / "flash_attention.cu", ops._declare)
    build_all(builds.values())
    for name, lib in builds.items():
        _ptxas_report(name, lib.build_log)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)

    checks = [(case, None, "own", torch.bfloat16) for case in CHECKS] + \
        [((b, hq, 1, sq, skv, d, causal, q_offset), LATENTS[d][1], v, dt)
         for b, hq, sq, skv, causal, q_offset, v, d in MLA_CHECKS
         for dt in (torch.bfloat16, torch.float32)]
    for i, (case, scale, v_mode, dt) in enumerate(checks):
        b, hq, hkv, sq, skv, d, causal, q_offset = case
        q, k, v = inputs(torch, b, hq, hkv, sq, skv, d, seed=100 + i, dtype=dt, v_mode=v_mode)
        kw = dict(causal=causal, q_offset=q_offset, sm_scale=scale)
        before = ops.LAUNCHES
        got = ops.flash_attention(q, k, v, **kw).float()
        want = ref.mha_reference(q, k, v, **kw).float()
        chunked = ref.mha_chunked(q, k, v, **kw).float()
        torch.cuda.synchronize()
        if ops.LAUNCHES != before + 1:
            raise AssertionError("flash_attention did not count its launch")
        err, err_c = (got - want).abs().max().item(), (got - chunked).abs().max().item()
        tol = BF16_TOL if dt == torch.bfloat16 else F32_TOL
        print(f"[check] {case} {str(dt)[6:]}" + (f" sm_scale {scale:.6f} v {v_mode}" if scale else "")
              + f": max abs err {err:.3e} against mha_reference, {err_c:.3e} against "
              "mha_chunked", flush=True)
        if not torch.allclose(got, want, atol=tol, rtol=tol):
            raise AssertionError(f"flash_attention differs by {err:.3e}")
        del q, k, v, got, want, chunked

    sdpa = torch.nn.functional.scaled_dot_product_attention
    port = ops.LIBRARY
    for b, hq, hkv, s, d in SHAPES:
        mla = d in LATENTS
        q, k, v = inputs(torch, b, hq, hkv, s, s, d, seed=7, v_mode="k" if mla else "own")
        scale = LATENTS[d][1] if mla else None
        flops = 4 * b * hq * d * s * (s + 1) // 2      # the visible (query, key) pairs
        times = {}
        try:
            for name in [*builds, *reversed(builds)]:
                ops.LIBRARY = builds[name]
                times.setdefault(name, []).append(_time_ms(
                    torch, lambda: ops.flash_attention(q, k, v, sm_scale=scale)))
        finally:
            ops.LIBRARY = port
        extra = ""
        if mla:     # the kernel with v a tensor of its own (two tiles a stage)
            v_own = k.clone()
            extra = f"; v not k {_time_ms(torch, lambda: ops.flash_attention(q, k, v_own, sm_scale=scale)):.4f} ms"
            del v_own
        calls = {"": lambda: sdpa(q, k, v, is_causal=True, enable_gqa=True, scale=scale)}
        if mla:     # PyTorch's flash backend stops at head dim 256: also k, v expanded
            kx, vx = (t.expand(b, hq, s, d) for t in (k, v))
            calls[" expanded"] = lambda: sdpa(q, kx, vx, is_causal=True, scale=scale)
        sdpa_txt = ", ".join(f"sdpa{name} ({sdpa_backend(torch, call)}) "
                             f"{_time_ms(torch, call):.4f} ms" for name, call in calls.items())
        bound, by = bound_ms(b, hq, hkv, s, d)
        print(f"[time] q {(b, hq, s, d)} kv {(b, hkv, s, d)}: " + ", ".join(
            f"{name} {t[0]:.4f} / {t[1]:.4f} ms ({flops / min(t) / 1e9:.1f} TFLOP/s)"
            for name, t in times.items())
              + f"{extra}; {sdpa_txt}; bound {bound:.6f} ms ({by})", flush=True)
        del calls
        del q, k, v
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
