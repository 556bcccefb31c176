"""The port stands alone: importing it pulls in neither JAX nor the reference
package, no source of it imports them, and its entry points run on the card
unless the caller asks for the CPU."""
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
MODULES = [
    "repro_torch", "repro_torch.configs", "repro_torch.convert",
    "repro_torch.core", "repro_torch.kernels", "repro_torch.kernels.build",
    "repro_torch.kernels.moe_gemm", "repro_torch.kernels.ssd_scan",
    "repro_torch.launch.serve",
    "repro_torch.launch.profile_serve", "repro_torch.models",
    "repro_torch.models.attention", "repro_torch.models.cache",
    "repro_torch.models.moe", "repro_torch.models.ssm", "repro_torch.obs",
    "repro_torch.quant",
    "repro_torch.serving",
]
FORBIDDEN = re.compile(
    r"^\s*(import|from)\s+(jax|jaxlib|repro)(\.|\s|$)"
    r"|import_module\(\s*[\"'](jax|repro)[\"'.]")


def test_import_leaves_jax_and_the_reference_out():
    code = ("import importlib, json, sys\n"
            f"for m in {MODULES!r}: importlib.import_module(m)\n"
            "print(json.dumps(sorted(m for m in sys.modules if m == 'jax' "
            "or m.startswith(('jax.', 'jaxlib')) or m == 'repro' "
            "or m.startswith('repro.'))))")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, check=True)
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_no_source_of_the_port_imports_jax_or_the_reference():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 30
    bad = [f"{f.relative_to(ROOT)}:{i}: {line.strip()}"
           for f in files
           for i, line in enumerate(f.read_text().splitlines(), 1)
           if FORBIDDEN.search(line)]
    assert bad == []


def test_entry_points_default_to_cuda_and_refuse_without_it():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from repro_torch.device import resolve_device
    from repro_torch.kernels.decode_attention.ops import \
        decode_attention_cache
    from repro_torch.models import Model
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import main
    cfg = get_config("chatglm3-6b").reduced()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Model(cfg).init(torch.Generator())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Model(cfg).init_cache(1, 8)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(["--arch", "chatglm3-6b", "--smoke"])
    # the analytic side needs no device
    assert Model(cfg).param_count() > 0
    q = torch.zeros((1, 1, 4, 8), device="meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        decode_attention_cache(q, q, q, q, q)


def test_make_cache_defaults_to_the_card():
    """`make_cache` resolves its device as every entry point does: the card
    unless the caller asks for the CPU, and without a card it raises."""
    from repro_torch.configs import get_config
    from repro_torch.models.cache import make_cache
    cfg = get_config("granite-moe-3b-a800m").reduced()
    cache = make_cache(cfg, 1, 8, torch.float32, device="cpu")
    assert cache["blocks"]["l0"]["k"].device.type == "cpu"
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available; pass "
                       "device='cpu' to run the port on the CPU"):
        make_cache(cfg, 1, 8)


def test_kernel_wrappers_run_their_plain_version_only_on_cpu_tensors():
    from repro_torch.kernels import (KERNELS, launch_counts,
                                     reset_launch_counts)
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               for s in [(1, 9, 4, 8), (1, 9, 2, 8), (1, 9, 2, 8)])
    reset_launch_counts()
    out = flash_attention(q, k, v)
    assert torch.equal(out, flash_attention_ref(q, k, v))
    # the CPU path is not a kernel launch
    assert launch_counts() == {name: 0 for name in KERNELS}


def test_kernel_build_is_keyed_by_its_sources_and_lazy():
    from repro_torch.kernels import build
    assert set(build.SOURCES) == {"flash_attention", "decode_attention",
                                  "dequant_matmul", "moe_gemm", "ssd_scan"}
    for name, src in build.SOURCES.items():
        assert (build.CSRC / src).is_file()
        path = build.library_path(name)
        assert path.parent == build.BUILD_DIR and path.suffix == ".so"
        assert path == build.library_path(name)
    assert "sm_90a" in " ".join(build.NVCC_FLAGS)
    assert build.BUILD_DIR == ROOT / "build" / "repro_torch"
    # importing the wrappers built nothing and loaded nothing
    assert build._loaded == {}
