"""The port stands alone: no module of ``repro_torch`` (nor chip_smoke.py)
imports JAX or the JAX package, its configs and analytic model's
constants (which the page store's NAND constants come from) equal the
reference's, and the CUDA ECDP kernels' codec constants equal the codec's
tables."""
from __future__ import annotations

import dataclasses
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from repro.configs import base as jbase
from repro.configs import paper_models as jpm
from repro_torch import configs as tcfg
from repro_torch.core import ecc as tecc

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


def test_importing_every_port_module_loads_no_jax_and_no_repro():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "names = [m.name for m in pkgutil.walk_packages("
        "repro_torch.__path__, 'repro_torch.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "bad = sorted(k for k in sys.modules if k == 'jax' "
        "or k.startswith('jax.') or k == 'repro' or k.startswith('repro.'))\n"
        "assert not bad, bad\n"
        "assert len(names) >= 79, names\n"
        "assert {'repro_torch.store.' + m for m in ('faults', 'nand', "
        "'page_pool', 'pagestore', 'streamer', 'expert_cache')} "
        "<= set(names), names\n"
        "assert {'repro_torch.kernels.decode_attn', 'repro_torch.launch', "
        "'repro_torch.launch.steps', 'repro_torch.models.dense', "
        "'repro_torch.models.moe', 'repro_torch.kernels.grouped_ecdp'} "
        "<= set(names), names\n"
        "assert {'repro_torch.obs', 'repro_torch.obs.registry', "
        "'repro_torch.obs.trace', 'repro_torch.obs.timeline', "
        "'repro_torch.runtime.fault', 'repro_torch.serving.prefix', "
        "'repro_torch.serving.server', 'repro_torch.serving.spec'} "
        "<= set(names), names\n"
        "assert {'repro_torch.configs.' + m for m in ('base', "
        "'paper_models', 'qwen3_32b', 'granite_8b', 'mistral_nemo_12b', "
        "'llama3_405b', 'qwen3_moe_30b_a3b', 'phi35_moe_42b', "
        "'recurrentgemma_9b', 'llava_next_34b', 'seamless_m4t_medium', "
        "'rwkv6_3b')} <= set(names), names\n"
        "assert {'repro_torch.configs', 'repro_torch.checkpoint.manager', "
        "'repro_torch.launch.serve', 'repro_torch.launch.deploy'} "
        "<= set(names), names\n"
        "assert {'repro_torch.optim', 'repro_torch.optim.adamw', "
        "'repro_torch.optim.schedule', 'repro_torch.optim.grad_compress', "
        "'repro_torch.data.pipeline', 'repro_torch.launch.train'} "
        "<= set(names), names\n"
        "assert {'repro_torch.simulator', 'repro_torch.simulator.hw', "
        "'repro_torch.simulator.system', 'repro_torch.simulator.baselines', "
        "'repro_torch.configs.shapes', 'repro_torch.launch.roofline', "
        "'repro_torch.launch.cost', 'repro_torch.launch.dryrun', "
        "'repro_torch.launch.report'} <= set(names), names\n"
        "assert {'repro_torch.launch.mesh', 'repro_torch.launch.sharding'} "
        "<= set(names), names\n"
        "print(len(names))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


_BAD_IMPORT = re.compile(
    r"^\s*(import\s+(jax|repro)\b(?!_torch)|from\s+(jax|repro)\b(?!_torch))",
    re.MULTILINE)


def _port_sources():
    files = sorted(PORT.rglob("*.py"))
    smoke = ROOT / "chip_smoke.py"
    return (files + ([smoke] if smoke.exists() else [])
            + sorted((ROOT / "examples").glob("torch_*.py")))


@pytest.mark.parametrize("path", _port_sources(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_source_has_no_jax_or_repro_import(path):
    hits = _BAD_IMPORT.findall(path.read_text())
    assert not hits, hits


@pytest.mark.parametrize(
    "path", sorted((ROOT / "examples").glob("torch_*.py")),
    ids=lambda p: p.name)
def test_torch_example_loads_no_jax_and_no_repro(path):
    """Importing a port example (its ``main`` not run) loads neither JAX
    nor the JAX package."""
    code = (
        "import importlib.util, sys\n"
        f"spec = importlib.util.spec_from_file_location('ex', {str(path)!r})\n"
        "mod = importlib.util.module_from_spec(spec)\n"
        "spec.loader.exec_module(mod)\n"
        "bad = sorted(k for k in sys.modules if k == 'jax' "
        "or k.startswith('jax.') or k == 'repro' or k.startswith('repro.'))\n"
        "assert not bad, bad\n"
        "assert 'repro_torch' in sys.modules\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_the_four_examples_have_port_counterparts():
    ported = {p.name[len("torch_"):]
              for p in (ROOT / "examples").glob("torch_*.py")}
    jax_examples = {p.name for p in (ROOT / "examples").glob("*.py")
                    if not p.name.startswith("torch_")}
    assert jax_examples == ported == {"quickstart.py", "train_tiny.py",
                                      "deploy_nvllm.py", "edge_serve.py"}


CONFIGS = ["OPT_1_3B", "OPT_2_7B", "OPT_6_7B", "OPT_13B", "OPT_30B",
           "LLAMA2_7B", "OPT_TINY"]


@pytest.mark.parametrize("name", CONFIGS)
def test_configs_equal_the_reference(name):
    ref, port = getattr(jpm, name), getattr(tcfg, name)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert port.param_count() == ref.param_count()
    assert port.active_param_count() == ref.active_param_count()
    assert port.ffn_param_fraction() == ref.ffn_param_fraction()
    assert [f.name for f in dataclasses.fields(tcfg.ArchConfig)] == \
        [f.name for f in dataclasses.fields(jbase.ArchConfig)]


def _c_array(src: str, name: str) -> list[int]:
    body = re.search(name + r"\[\d+\]\s*=\s*\{([^}]*)\}", src).group(1)
    return [int(tok.rstrip("ull"), 0) for tok in re.findall(r"0x[0-9a-f]+ull|\d+",
                                                             body)]


def test_ecdp_kernel_constants_equal_the_codec_tables():
    # ecdp.cu, paged_ecdp.cu and grouped_ecdp.cu share the kernel body and
    # its tables
    csrc = PORT / "kernels" / "csrc"
    for name in ("ecdp.cu", "paged_ecdp.cu", "grouped_ecdp.cu"):
        assert '#include "ecdp_core.cuh"' in (csrc / name).read_text()
    src = (csrc / "ecdp_core.cuh").read_text()
    phys_mask, data_pos = tecc.tables()
    assert _c_array(src, "DATA_POS") == data_pos.tolist()
    masks = []
    for j in range(7):
        bits = 0
        for r in range(8):
            bits |= int(phys_mask[j, r]) << (8 * r)
        masks.append(bits)
    assert _c_array(src, "PHYS_MASK64") == masks
    # and the tables are the reference codec's
    from repro.core import ecc as jecc
    jm, jd = jecc.tables()
    np.testing.assert_array_equal(phys_mask, jm)
    np.testing.assert_array_equal(data_pos, jd)


def test_nand_constants_equal_the_reference():
    """Every constant of the port's analytic model equals the reference's,
    and the page store takes its NAND constants from it."""
    from repro.core.scheduler import shard_planes
    from repro.simulator import hw as jhw
    from repro_torch.simulator import hw
    from repro_torch.store import nand
    def consts(mod):                     # configs as their fields
        return {k: dataclasses.asdict(v) if dataclasses.is_dataclass(v) else v
                for k, v in vars(mod).items() if k.isupper()}
    assert consts(hw) == consts(jhw) and "NVLLM_8C" in consts(hw)
    assert (nand.PAGE_BYTES, nand.PLANE_READ_S, nand.N_PLANES) == \
        (jhw.PAGE_BYTES, jhw.PLANE_READ_S, jhw.NVLLM_8C.n_planes)
    assert nand.nand_read_seconds is hw.nand_read_seconds
    for reads in ([], [0, 3, 1], [7] * 32):
        assert nand.nand_read_seconds(reads) == jhw.nand_read_seconds(reads)
    for planes, shards in ((32, 1), (32, 4), (8, 8)):
        np.testing.assert_array_equal(nand.shard_planes(planes, shards),
                                      shard_planes(planes, shards))
    with pytest.raises(ValueError):
        nand.shard_planes(32, 3)
