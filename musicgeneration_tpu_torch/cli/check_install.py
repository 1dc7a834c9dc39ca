"""Environment check (reference tools/check_install.py): the port of
``musicgeneration_tpu.cli.check_install``.

    python -m musicgeneration_tpu_torch.cli.check_install

Reports numpy and torch with its CUDA build, the visible CUDA device and
its compute capability (the kernels are built for sm_90a, so 9.0 is
wanted), ``nvcc`` for ``ops/cuda_build.py``, whether ``triton`` is
present (no kernel of the port needs it), the model registry, and one
kernel (A, ``csrc/relative_attention.cu``) built by ``nvcc`` and launched
on the card against its plain version. Exit code 0 means a usable
install; a missing CUDA device or ``nvcc`` is a problem, not a fallback.
"""

from __future__ import annotations

import importlib
import sys


def _kernel_smoke() -> float:
    """Build kernel A, launch it on a [1, 1, 128, 64] causal problem and
    return its largest difference from the plain version."""
    import torch

    from ..ops import cuda_build
    from ..ops.fused_attention import (fused_relative_attention,
                                       fused_relative_attention_plain)

    cuda_build.build(["relative_attention"])
    gen = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(1, 1, 128, 64, generator=gen).cuda()
               for _ in range(3))
    e = torch.randn(128, 64, generator=gen).cuda()
    out = fused_relative_attention(q, k, v, e)
    ref = fused_relative_attention_plain(q, k, v, e)
    torch.cuda.synchronize()
    if not bool(torch.isfinite(out).all()):
        raise RuntimeError("kernel A returned non-finite values")
    return float((out - ref).abs().max())


def main(argv=None) -> int:
    ok = True

    for mod in ("numpy", "torch"):
        try:
            m = importlib.import_module(mod)
            print(f"[x] {mod} {getattr(m, '__version__', '?')}")
        except ImportError as e:
            print(f"[ ] {mod}: {e}")
            return 1

    import torch

    cuda = torch.cuda.is_available()
    if torch.version.cuda:
        print(f"[x] torch CUDA build {torch.version.cuda}")
    else:
        print("[ ] torch is built without CUDA: the port's kernels run on "
              "an NVIDIA GPU")
        ok = False
    if cuda:
        major, minor = torch.cuda.get_device_capability(0)
        mark = "x" if (major, minor) == (9, 0) else " "
        print(f"[{mark}] CUDA device: {torch.cuda.get_device_name(0)} "
              f"(x{torch.cuda.device_count()}), compute capability "
              f"{major}.{minor} (sm_90 wanted: the kernels are built for "
              "sm_90a)")
        ok = ok and mark == "x"
    else:
        print("[ ] no CUDA device visible (torch.cuda.is_available() is "
              "False)")
        ok = False

    from ..ops import cuda_build

    try:
        print(f"[x] nvcc {cuda_build._nvcc()} (ops/cuda_build.py)")
        have_nvcc = True
    except RuntimeError as e:
        print(f"[ ] {e}")
        have_nvcc = ok = False
    try:
        import triton
        print(f"[x] triton {triton.__version__} (no kernel of the port "
              "needs it)")
    except ImportError:
        print("[-] triton not installed (no kernel of the port needs it)")

    try:
        from ..models.registry import registered_models
        print(f"[x] registered models: {', '.join(registered_models())}")
    except Exception as e:  # noqa: BLE001 — report, do not crash
        print(f"[ ] model registry import failed: {e}")
        ok = False

    if cuda and have_nvcc:
        try:
            err = _kernel_smoke()
            print(f"[x] kernel A built by nvcc and launched on the card "
                  f"(max abs difference from its plain version {err:.2e})")
            ok = ok and err < 1e-3
        except Exception as e:  # noqa: BLE001 — report, do not crash
            print(f"[ ] kernel build/launch failed: {e}")
            ok = False
    else:
        print("[ ] kernel build and launch skipped: it needs a CUDA device "
              "and nvcc")
    print("OK" if ok else "PROBLEMS FOUND")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
