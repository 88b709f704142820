"""Time flash attention (K2) on the card, against
``scaled_dot_product_attention`` and the bound, at the LM paths' prefill
shapes, and against other builds of the kernel.

    PYTHONPATH=src python3 -m repro_torch.kernels.flash_attention.bench [DIR ...]

Each DIR holds an edited copy of this kernel's ``csrc/`` directory (a
variant, named by DIR, or by its parent when DIR is called ``csrc``; for
example under ``build/dev/``, which ``.gitignore`` lists). It is
built beside the port's own kernel and timed in turns with it (every
build, then every build again in reverse order), so that versions are
compared within one run on one card. Prints each build's ptxas report for
the bf16 kernels (registers, spills, wgmma serialization remarks), the
card's name and power limit, the port's kernel checked against
``mha_reference`` in bfloat16 (tolerance 2e-2; the variants are timed, not
checked), and one line per shape. Needs a CUDA device.
"""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

BF16_TOL = 2e-2
H100_BF16_FLOPS = 989e12        # dense bf16 tensor cores, SXM, 700 W
# (B, Hq, Hkv, Sq, Skv, D, causal, q_offset): every head dim, GQA, ragged
# lengths, q_offset, non-causal, and both prefill shapes.
CHECKS = [(1, 1, 1, 128, 128, 64, True, 0), (1, 1, 1, 128, 128, 128, False, 0),
          (1, 2, 2, 256, 256, 112, True, 0), (2, 4, 2, 200, 200, 16, True, 0),
          (2, 2, 2, 256, 256, 32, False, 0), (1, 2, 2, 128, 256, 64, True, 128),
          (1, 4, 2, 333, 333, 96, True, 0), (1, 16, 8, 1000, 1000, 128, True, 0),
          (2, 4, 4, 200, 200, 112, False, 0), (1, 2, 2, 70, 70, 128, True, 0),
          (4, 16, 8, 1819, 1819, 128, True, 0), (4, 32, 32, 1819, 1819, 112, True, 0)]
# (B, Hq, Hkv, S, D), causal: qwen3-1.7b's and zamba2-7b's prefill waves,
# and 2,048 heads of one 128-key tile each (a CTA's fixed cost).
SHAPES = [(4, 16, 8, 1819, 128), (4, 32, 32, 1819, 112), (4, 16, 8, 985, 128),
          (1, 2048, 2048, 128, 128)]


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


def _inputs(torch, b, hq, hkv, sq, skv, d, seed):
    gen = torch.Generator().manual_seed(seed)
    return tuple(torch.randn(*s, generator=gen).to("cuda", torch.bfloat16)
                 for s in ((b, hq, sq, d), (b, hkv, skv, d), (b, hkv, skv, d)))


def _ptxas_report(name: str, log: str) -> None:
    keep = False
    for line in log.splitlines():
        if "Compiling entry" in line:
            keep = "flash_kernel_sm90" in line
            if keep:
                print(f"[ptxas {name}] {line.split('flash_kernel_sm90')[1][:10]}", flush=True)
        elif keep and ("registers" in line or "spill" in line):
            print(f"[ptxas {name}]   {line.strip()}", flush=True)
        if "C75" in line or "error" in line:
            print(f"[ptxas {name}] {line.strip()[:160]}", flush=True)


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

    for i, (b, hq, hkv, sq, skv, d, causal, q_offset) in enumerate(CHECKS):
        q, k, v = _inputs(torch, b, hq, hkv, sq, skv, d, seed=100 + i)
        got = ops.flash_attention(q, k, v, causal=causal, q_offset=q_offset).float()
        want = ref.mha_reference(q, k, v, causal=causal, q_offset=q_offset).float()
        chunked = ref.mha_chunked(q, k, v, causal=causal, q_offset=q_offset).float()
        torch.cuda.synchronize()
        err, err_c = (got - want).abs().max().item(), (got - chunked).abs().max().item()
        print(f"[check] {(b, hq, hkv, sq, skv, d, causal, q_offset)}: max abs err {err:.3e} "
              f"against mha_reference, {err_c:.3e} against mha_chunked", flush=True)
        if not torch.allclose(got, want, atol=BF16_TOL, rtol=BF16_TOL):
            raise AssertionError(f"flash_attention differs by {err:.3e}")

    sdpa = torch.nn.functional.scaled_dot_product_attention
    port = ops.LIBRARY
    for b, hq, hkv, s, d in SHAPES:
        q, k, v = _inputs(torch, b, hq, hkv, s, s, d, seed=7)
        flops = 4 * b * hq * d * s * (s + 1) // 2      # the visible (query, key) pairs
        times = {}
        try:
            for name in [*builds, *reversed(builds)]:
                ops.LIBRARY = builds[name]
                times.setdefault(name, []).append(_time_ms(torch, lambda: ops.flash_attention(q, k, v)))
        finally:
            ops.LIBRARY = port
        sdpa_ms = _time_ms(torch, lambda: sdpa(q, k, v, is_causal=True, enable_gqa=True))
        print(f"[time] q {(b, hq, s, d)} kv {(b, hkv, s, d)}: " + ", ".join(
            f"{name} {t[0]:.4f} / {t[1]:.4f} ms ({flops / min(t) / 1e9:.1f} TFLOP/s)"
            for name, t in times.items())
              + f"; sdpa {sdpa_ms:.4f} ms; bound {flops / H100_BF16_FLOPS * 1e3:.6f} ms",
              flush=True)
        del q, k, v
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
