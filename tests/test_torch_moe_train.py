"""The port's training of the MoE stacks (A13's MoE half) against the JAX
package, on the CPU.

Every leaf's gradient of ``loss_fn`` for olmoe's routed experts and for
deepseek's MLA, shared experts and first dense layer, through the router,
the sorted dispatch and the expert FFN's plain version, in float32 against
``jax.grad`` (``test_torch_train.check_gradients``, its fixtures and
tolerance); then the launcher and ``examples/train_moe_torch.py`` end to
end on the MoE smoke.

A module of its own with few tests: pytest-xdist's ``--dist loadfile``
starts the files with the most tests first, and the JAX gradients here are
among the suite's heaviest references, so they run after its opening
minutes, where the JAX package's multi-device engine tests sit close to
their time limit.
"""
import importlib.util
import os

import pytest

from repro_torch.launch import train as train_cli
from test_torch_engine import share_cores_among_workers  # noqa: F401  (autouse)
from test_torch_train import check_gradients
from test_torch_train import jax_float32  # noqa: F401  (autouse)


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "deepseek-v2-lite-16b"])
def test_moe_gradients_match_jax(arch, monkeypatch):
    check_gradients(arch, "sdpa", monkeypatch)


def test_launcher_trains_the_moe_smoke(tmp_path, capsys):
    train_cli.main(["--arch", "olmoe-1b-7b", "--smoke", "--steps", "2", "--batch", "4",
                    "--seq", "32", "--device", "cpu", "--transport", "local",
                    "--checkpoint-dir", str(tmp_path / "ckpt")])
    assert "[train] done: 2 steps, loss=" in capsys.readouterr().out
    with pytest.raises(NotImplementedError, match="A14"):
        train_cli.main(["--arch", "olmoe-1b-7b", "--smoke", "--device", "cpu",
                        "--transport", "injected", "--checkpoint-dir", str(tmp_path / "x")])


def test_moe_example_trains(tmp_path, capsys):
    """``examples/train_moe_torch.py`` in-process at a tiny width on the CPU:
    both of the JAX example's lines, the counts those of the config."""
    path = os.path.join(os.path.dirname(__file__), "..", "examples", "train_moe_torch.py")
    spec = importlib.util.spec_from_file_location("train_moe_torch", path)
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    example.main(["--d-model", "64", "--layers", "2", "--steps", "3", "--batch", "4",
                  "--seq", "32", "--device", "cpu", "--ckpt", str(tmp_path / "ckpt")])
    out = capsys.readouterr().out
    cfg = example.model_config(64, 2)
    assert (f"[train_moe] {cfg.param_count()/1e6:.1f}M params "
            f"({cfg.active_param_count()/1e6:.1f}M active/token)") in out
    assert "[train_moe] done: loss " in out
