"""Boundaries of the PyTorch port.

* No file under ``apex_tpu_torch/``, nor ``chip_smoke.py``, imports ``jax``
  or anything of the JAX package ``apex_tpu`` (``apex_tpu_torch`` itself is
  not the JAX package).
* Entry points default to the card: on a host without CUDA they raise
  instead of quietly running on the CPU.
* Every kernel has an fp32, a bf16 and an fp16 branch (the layer norm,
  l2norm, cross-entropy, flash and Adam's model copy take fp16 as the
  JAX package's kernels do); a dtype without one (float64) is refused
  with a ``TypeError`` in the wrapper's checks, before any launch.  CPU
  tensors reach those checks here; the card's own tests launch with fp16
  CUDA tensors.
"""
import ast
import pathlib

import pytest
import torch

import apex_tpu_torch
from apex_tpu_torch import amp
from apex_tpu_torch.models import TransformerConfig, transformer_init
from apex_tpu_torch.optimizers import FusedLAMB
from apex_tpu_torch.serve import InferenceEngine
from apex_tpu_torch.utils.device import resolve_device

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "apex_tpu_torch").rglob("*.py")) \
    + [ROOT / "chip_smoke.py"]


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "apex_tpu")


def _imports(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args \
                and isinstance(node.args[0], ast.Constant):
            yield str(node.args[0].value)


def test_port_files_exist():
    names = {p.relative_to(ROOT).as_posix() for p in PORT_FILES}
    assert "chip_smoke.py" in names
    assert (ROOT / "chip_smoke.py").is_file()
    assert "apex_tpu_torch/serve/engine.py" in names
    for module in ("parallel/mesh.py", "parallel/collectives.py",
                   "contrib/optimizers/distributed_fused.py", "train.py",
                   "multi_tensor_apply/kernels.py", "ops/fused_mlp.py",
                   "mlp/mlp.py", "optimizers/fused_adam.py",
                   "contrib/optimizers/fp16_optimizer.py",
                   "parallel/sync_batchnorm.py", "models/resnet.py",
                   "contrib/groupbn/batch_norm.py",
                   "optimizers/fused_sgd.py", "parallel/LARC.py",
                   "parallel/distributed.py"):
        assert f"apex_tpu_torch/{module}" in names, module
    assert len(names) > 15


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[p.relative_to(ROOT).as_posix()
                              for p in PORT_FILES])
def test_no_jax_or_apex_tpu_imports(path):
    bad = [m for m in _imports(path) if _forbidden(m)]
    assert not bad, f"{path} imports {bad}"


def test_scan_catches_forbidden_imports(tmp_path):
    f = tmp_path / "m.py"
    f.write_text("import jax.numpy as jnp\nfrom apex_tpu.serve import x\n"
                 "from apex_tpu_torch.serve import y\n"
                 "importlib.import_module('apex_tpu.ops')\n")
    assert [m for m in _imports(f) if _forbidden(m)] == [
        "jax.numpy", "apex_tpu.serve", "apex_tpu.ops"]


def test_port_package_is_not_the_jax_package():
    assert pathlib.Path(apex_tpu_torch.__file__).parent.name == \
        "apex_tpu_torch"


def _no_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA; the no-CUDA refusal cannot show")


def test_default_device_refuses_without_cuda():
    _no_cuda()
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")


def test_engine_without_device_does_not_run_on_cpu():
    _no_cuda()
    cfg = TransformerConfig(vocab_size=32, max_len=64, num_layers=1,
                            d_model=16, num_heads=2, d_ff=32)
    params = transformer_init(cfg, torch.Generator().manual_seed(0),
                              device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        InferenceEngine(params, cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        transformer_init(cfg, torch.Generator().manual_seed(0))


def test_training_without_device_does_not_run_on_cpu():
    """The training flow a user writes (weights from ``transformer_init``,
    ``amp.initialize``, ``train_step``) asks for the card by default: with
    no device given it raises here instead of training on the CPU."""
    _no_cuda()
    cfg = TransformerConfig(vocab_size=32, max_len=64, num_layers=1,
                            d_model=16, num_heads=2, d_ff=32)
    with pytest.raises(RuntimeError, match="CUDA"):
        params = transformer_init(cfg, torch.Generator().manual_seed(0))
        amp.initialize(params, FusedLAMB(impl="fused"), opt_level="O5",
                       verbosity=0)
    with pytest.raises(RuntimeError, match="CUDA"):
        amp.scaler.init("dynamic")


def test_zero_state_from_jax_defaults_to_the_card():
    """``state_from_jax`` puts the state on the card unless asked for the
    CPU: without CUDA it raises instead of building a CPU state."""
    _no_cuda()
    import numpy as np
    from apex_tpu_torch.contrib.optimizers import state_from_jax

    class ShardedLAMBState:
        count, p, m, v, gnorm = (np.int32(1), np.zeros(256, np.float32),
                                 np.zeros(256, np.float32),
                                 np.zeros(256, np.float32), np.float32(0))
    with pytest.raises(RuntimeError, match="CUDA"):
        state_from_jax(ShardedLAMBState(), 0, 2)
    st = state_from_jax(ShardedLAMBState(), 1, 2, device="cpu")
    assert type(st).__name__ == "ShardedLAMBState" and st.p.shape == (128,)


def test_mlp_init_without_device_does_not_run_on_cpu():
    """``MLP.init`` asks for the card by default: without CUDA it raises
    instead of making CPU weights; the fp16 flow on the CPU must say so."""
    _no_cuda()
    import numpy as np
    from apex_tpu_torch.mlp import MLP, mlp_params_from_jax
    from apex_tpu_torch.optimizers import adam_state_from_jax
    mlp = MLP([8, 16, 4])
    with pytest.raises(RuntimeError, match="CUDA"):
        mlp.init(torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="CUDA"):
        mlp_params_from_jax({"weights": [], "biases": []})
    with pytest.raises(RuntimeError, match="CUDA"):
        adam_state_from_jax((np.int32(1), np.zeros(4, np.float32),
                             np.zeros(4, np.float32), None))
    params = mlp.init(torch.Generator().manual_seed(0), device="cpu")
    assert params["weights"][0].device.type == "cpu"


def test_resnet_entry_points_default_to_the_card():
    """``resnet_init``, ``resnet_params_from_jax``, the data-parallel
    wrapper and the batch-norm modules' ``init`` ask for the card unless
    given a device: without CUDA they raise instead of running on the CPU;
    with ``device="cpu"`` they run there."""
    _no_cuda()
    import numpy as np
    from apex_tpu_torch.contrib.groupbn import BatchNorm2d_NHWC
    from apex_tpu_torch.models import resnet18_config, resnet_init
    from apex_tpu_torch.models.resnet import resnet_params_from_jax
    from apex_tpu_torch.parallel import (DistributedDataParallel,
                                         SyncBatchNorm)
    cfg = resnet18_config(width=4, num_classes=3)
    for call in (lambda: resnet_init(torch.Generator().manual_seed(0), cfg),
                 lambda: resnet_params_from_jax(
                     {"fc_w": np.zeros((2, 3), np.float32)},
                     {"bn_init": {"mean": np.zeros(2, np.float32)}}),
                 lambda: DistributedDataParallel(),
                 lambda: SyncBatchNorm(4).init(),
                 lambda: BatchNorm2d_NHWC(4).init()):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    params, state = resnet_init(torch.Generator().manual_seed(0), cfg,
                                device="cpu")
    assert params["conv_init"].device.type == "cpu"
    assert DistributedDataParallel(device="cpu").device.type == "cpu"
    ddp = DistributedDataParallel(device="cpu")
    with pytest.raises(RuntimeError, match="made for cpu"):
        ddp.allreduce_grads({"w": torch.zeros(2, device="meta")})


def _fp16_cases(h16=torch.float16):
    """Each wrapper's checks on inputs of ``h16`` (any dtype) where it
    reads its dtype."""
    from apex_tpu_torch.contrib.multihead_attn import flash
    from apex_tpu_torch.contrib.xentropy import softmax_xentropy as xent
    from apex_tpu_torch.multi_tensor_apply import kernels
    from apex_tpu_torch.ops import layer_norm
    f32 = torch.float32
    x32 = torch.zeros(4, 64)
    q16 = torch.zeros(2, 8, 64, dtype=h16)
    return {
        "ln_fwd_x": lambda: layer_norm._check_cuda_inputs(
            x32.to(h16), None, None),
        "ln_weight": lambda: layer_norm._check_cuda_inputs(
            x32, torch.ones(64, dtype=h16), torch.zeros(64, dtype=h16)),
        "ln_bwd_weight": lambda: layer_norm._check_param(
            torch.ones(64, dtype=h16), "weight", x32),
        "l2norm": lambda: kernels._check_l2norm_input(
            torch.zeros(256, dtype=h16)),
        "xent": lambda: xent._check_cuda_inputs(
            torch.zeros(4, 32, dtype=h16), torch.zeros(4, dtype=torch.long)),
        "flash": lambda: flash._check_cuda_inputs(
            q16, q16, q16, torch.zeros(1, 1, 8, dtype=f32), 0.0),
        "adam_model_copy": lambda: kernels._copy_code(h16),
    }


@pytest.mark.parametrize("wrapper", ["ln_fwd_x", "ln_weight",
                                     "ln_bwd_weight", "l2norm", "xent",
                                     "flash", "adam_model_copy"])
def test_fp16_refused_before_any_launch(wrapper):
    """fp16 now passes every wrapper's checks; float64, which no kernel
    has a branch for, is refused before any launch."""
    from apex_tpu_torch.utils import build
    before = dict(build.LAUNCHES)
    _fp16_cases()[wrapper]()
    with pytest.raises(TypeError, match="float64"):
        _fp16_cases(torch.float64)[wrapper]()
    assert dict(build.LAUNCHES) == before


def test_float16_has_a_code_only_where_allowed():
    from apex_tpu_torch.utils import build
    assert build.FLOATS == (torch.float32, torch.bfloat16, torch.float16)
    assert [build.dtype_code(d) for d in build.FLOATS] == [0, 1, 2]
    with pytest.raises(TypeError, match="float32/bfloat16/float16"):
        build.dtype_code(torch.float64)
