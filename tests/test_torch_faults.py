"""Two faults of the port against the JAX reference, closed:

- Dropout in ``Mlp`` and ``SS2D`` drew from torch's global RNG; the JAX
  modules draw from the step's ``"dropout"`` stream.  The port's Dropout now
  draws from the trainer's step-seeded generator, as DropPath does.
- The CLI's defaults differed from the JAX CLI's (``--mode``,
  ``--test_model``); ``--flops_report`` now runs ``--mode`` after the report
  (``tests/test_torch_probe.py::test_flops_report_params_match_jax``).  The
  CLI takes JAX's presets and precision flags, and records them as JAX does.

Cheap: a tiny model on the CPU, no JAX model and no jit.
"""

import argparse
import dataclasses
import json
import math
import os
from unittest import mock

import pytest
import torch

from focalnet_tpu.configs import PRESETS as JAX_PRESETS
from focalnet_tpu.main import parse_args as jax_parse_args
from focalnet_tpu_torch.main import main, parse_args
from focalnet_tpu_torch.models import Dropout, build_net, set_dropout_generator
from focalnet_tpu_torch.train.trainer import step_seed

torch.set_num_threads(1)

TINY = dict(vssg_dim=16, ssm_d_state=4, drop_path_rate=0.0)


def _tiny(**kw):
    return build_net("1mlp_g2", device="cpu",
                     generator=torch.Generator().manual_seed(1234), **TINY, **kw).train()


def _forward(model, x, seed, step):
    g = torch.Generator().manual_seed(step_seed(seed, step))
    set_dropout_generator(model, g)
    with torch.no_grad():
        return model(x)[2]


def test_dropout_masks_from_step_seed():
    """At mlp_drop_rate = ssm_drop_rate = 0.2 the same seed and step give the
    same output (the same masks), another step other masks, and eval mode
    none of them."""
    model = _tiny(mlp_drop_rate=0.2, ssm_drop_rate=0.2)
    drops = [m for m in model.modules() if isinstance(m, Dropout)]
    # 12 blocks: one in SS2D, one in Mlp (applied twice)
    assert len(drops) == 24 and all(m.rate == 0.2 for m in drops)
    assert list(model.state_dict()) == list(_tiny().state_dict())  # no new keys
    x = torch.rand(1, 32, 32, 3, generator=torch.Generator().manual_seed(0))
    a = _forward(model, x, 1234, 7)
    torch.manual_seed(99)  # the global RNG plays no part
    b = _forward(model, x, 1234, 7)
    assert torch.equal(a, b)
    assert not torch.equal(a, _forward(model, x, 1234, 8))
    with torch.no_grad():
        plain = model.eval()(x)[2]
    assert not torch.equal(a, plain)


def test_dropout_identity_in_eval_and_at_rate_0():
    """Eval mode and rate 0 return the input and draw nothing; training at a
    nonzero rate without a generator raises; kept elements are scaled by
    1 / keep, at a keep rate within binomial bounds."""
    x = torch.ones(50000)
    g = torch.Generator().manual_seed(3)
    state = g.get_state()
    drop = Dropout(0.2)
    drop.generator = g
    assert drop.eval()(x) is x
    zero = Dropout(0.0).train()
    zero.generator = g
    assert zero(x) is x
    assert torch.equal(g.get_state(), state)
    with pytest.raises(RuntimeError, match="needs a generator"):
        Dropout(0.2).train()(x)
    y = drop.train()(x)
    kept = y != 0
    assert torch.equal(y[kept], torch.full_like(y[kept], 1 / 0.8))
    rate, sigma = kept.float().mean().item(), math.sqrt(0.8 * 0.2 / 50000)
    assert abs(rate - 0.8) < 5 * sigma


def test_train_forward_at_rate_0_draws_nothing():
    """The flagship's rates (dropout 0, here drop_path 0 too): a train-mode
    forward leaves the step generator untouched, so the DropPath masks of
    every step, and every train-parity test, are as before."""
    model = _tiny()
    g = torch.Generator().manual_seed(step_seed(1234, 0))
    state = g.get_state()
    set_dropout_generator(model, g)
    with torch.no_grad():
        model(torch.rand(1, 32, 32, 3))
    assert torch.equal(g.get_state(), state)


def _choices(parse, argv):
    """{dest: choices} of the parser that ``parse(argv)`` builds."""
    parsers = []
    real = argparse.ArgumentParser.parse_args

    def spy(self, *args, **kw):
        parsers.append(self)
        return real(self, *args, **kw)

    with mock.patch.object(argparse.ArgumentParser, "parse_args", spy):
        parse(argv)
    return {a.dest: a.choices for a in parsers[0]._actions if a.choices}


def test_cli_defaults_match_jax(tmp_path):
    """``parse_args([])``: the mode is JAX's (train), and the checkpoint to
    serve is the reference-format counterpart of JAX's Orbax default.
    ``--preset``, ``--compute_dtype`` and ``--ssm_out_dtype`` take JAX's
    choices, and ``config.json`` written under ``--compute_dtype bfloat16
    --ssm_out_dtype bfloat16`` holds JAX's fields and values."""
    port, ref = parse_args([]), jax_parse_args([])
    assert port.mode == ref.mode == "train"
    assert port.test_model == ref.test_model + ".pkl" == "results/weights/Best.pkl"
    assert port.model_save_dir == ref.model_save_dir
    assert port.flops_report is ref.flops_report is False
    port_choices, jax_choices = _choices(parse_args, []), _choices(jax_parse_args, [])
    for dest in ("preset", "compute_dtype", "ssm_out_dtype"):
        assert port_choices[dest] == jax_choices[dest], dest
    assert port_choices["preset"] == ["baseline", "1mlp", "1mlp_g2", "1mlp_g4"]

    out = str(tmp_path / "w")
    recipe = ["--compute_dtype", "bfloat16", "--ssm_out_dtype", "bfloat16"]
    with pytest.raises(SystemExit, match="needs --input"):  # after config.json
        main(["--mode", "infer", "--device", "cpu", "--preset", "1mlp", *recipe,
              "--model_save_dir", out, "--result_dir", str(tmp_path / "images")])
    with open(os.path.join(out, "config.json")) as f:
        got = json.load(f)["model"]
    want = json.loads(json.dumps(dataclasses.asdict(JAX_PRESETS["1mlp"].replace(
        compute_dtype="bfloat16", ssm_out_dtype="bfloat16"))))
    assert {"compute_dtype", "ssm_out_dtype", "ssm_proj_dtype", "use_checkpoint"} <= set(got)
    assert set(got) <= set(want)
    shared = set(got) - {"scan_backend"}  # the backends' names differ
    assert {k: got[k] for k in shared} == {k: want[k] for k in shared}
