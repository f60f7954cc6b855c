"""The port's structure checks (``repro_torch.launch.{specs, zero_dryrun,
dryrun, fake}``) on the CPU.

The specs mirror the reference's ``TestSpecs`` (``tests/test_launch.py``);
``zero_dryrun --skip-lowering`` equals the reference's JSON key for key
(the same plans and the same TPU cost model, copied); the dry runs that
bring up a fake world run in subprocesses, as the reference's own dry-run
tests do (a fake world must be its process's only process group).  All
comparisons are exact: shapes, counts and byte sums.
"""

import json
import os
import subprocess
import sys

import pytest
import torch

from repro_torch import tree
from repro_torch.configs import INPUT_SHAPES, get_config
from repro_torch.core import plan_from_decision, schedule
from repro_torch.dist.collectives import make_flat_spec
from repro_torch.launch import fake
from repro_torch.launch.specs import decode_specs, input_specs, state_specs
from repro_torch.launch.zero_dryrun import tpu_costs
from repro_torch.models import model
from repro_torch.models.attention import KVCache
from repro_torch.optim import adamw

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(args, timeout=300):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    env.pop("XLA_FLAGS", None)
    return subprocess.run([sys.executable, "-m", *args], capture_output=True,
                          text=True, env=env, timeout=timeout, cwd=ROOT)


class TestSpecs:
    @pytest.mark.parametrize("arch", ["granite-3-2b", "llava-next-34b",
                                      "hubert-xlarge", "xlstm-350m"])
    def test_input_specs_shapes(self, arch):
        cfg = get_config(arch)
        specs = input_specs(cfg, INPUT_SHAPES["train_4k"])
        assert "labels" in specs
        if cfg.frontend == "audio":
            assert specs["frames"].shape == (256, 4096, cfg.d_model)
        elif cfg.frontend == "vision":
            nv = min(cfg.num_vision_tokens, 4095)
            assert specs["vision_embeds"].shape == (256, nv, cfg.d_model)
            assert specs["tokens"].shape == (256, 4096 - nv)
        else:
            assert specs["tokens"].shape == (256, 4096)
        assert specs["labels"].dtype == torch.int64

    def test_decode_specs_cache_sizes(self):
        cfg = get_config("gemma2-2b")
        token, caches = decode_specs(cfg, INPUT_SHAPES["decode_32k"])
        assert token.shape == (128, 1)
        assert len(caches) == cfg.num_layers
        for kind, c in zip(cfg.layer_kinds(), caches):
            assert isinstance(c, KVCache)
            want = cfg.sliding_window if kind == "local_attn" else 32768
            assert c.k.shape == (128, want, cfg.num_kv_heads, cfg.head_dim)

    def test_no_allocation(self):
        """Every leaf of the specs lies on ``meta``: no bytes."""
        cfg = get_config("grok-1-314b")
        params, opt = state_specs(cfg, adamw(1e-4))
        leaves = tree.leaves((input_specs(cfg, INPUT_SHAPES["train_4k"]),
                              params, opt))
        assert leaves and all(x.device.type == "meta" for x in leaves)
        assert opt.mu is not None and \
            tree.structure(opt.mu) == tree.structure(params)
        assert params["layers"][0]["moe"]["up"].dtype == torch.bfloat16


def test_skip_lowering_json_equals_the_reference(tmp_path):
    mine, theirs = tmp_path / "port.jsonl", tmp_path / "ref.jsonl"
    for module, out in (("repro_torch", mine), ("repro", theirs)):
        proc = _run([f"{module}.launch.zero_dryrun", "--skip-lowering",
                     "--out", str(out)])
        assert proc.returncode == 0, proc.stderr[-2000:]
    a, b = json.loads(mine.read_text()), json.loads(theirs.read_text())
    assert a == b
    assert list(a["strategies"]) == ["sequential", "lbl", "ibatch",
                                     "dynacomm"]


def test_fake_zero_step_launches_the_plans_buckets(tmp_path):
    """A reduced granite-3-2b in the fake world of 256 ranks: each
    strategy's recorded all-gathers and reduce-scatters are its plan's
    pull and push buckets, with the FlatSpec byte math."""
    out = tmp_path / "z.jsonl"
    proc = _run(["repro_torch.launch.zero_dryrun", "--reduced", "--out",
                 str(out)])
    assert proc.returncode == 0, proc.stderr[-2000:]
    res = json.loads(out.read_text())
    assert res["fake_world"] == 256
    cfg = get_config("granite-3-2b").reduced()
    specs = [make_flat_spec(t, 256) for t in model.sched_layer_trees(
        model.param_shapes(cfg))]
    costs = tpu_costs("granite-3-2b", "train_4k", 256, cfg)
    for strat, rec in res["strategies"].items():
        plan = plan_from_decision(*schedule(costs, strat),
                                  model.num_sched_layers(cfg))
        assert rec["recorded_all_gathers"] == rec["fwd_buckets"] \
            == len(plan.forward)
        assert rec["recorded_reduce_scatters"] == rec["bwd_buckets"] \
            == len(plan.backward)
        assert rec["all_gather_bytes"] == 4 * sum(s.shard_size
                                                  for s in specs)
        assert rec["reduce_scatter_bytes"] == 4 * sum(s.padded
                                                      for s in specs)
        # plus the loss's 4-byte all-reduce
        assert rec["operand_bytes_per_device"] == \
            rec["all_gather_bytes"] + rec["reduce_scatter_bytes"] + 4
        assert rec["peak_live_bytes"] > 0


def test_dry_run_of_a_decode_combination_prints_ok():
    proc = _run(["repro_torch.launch.dryrun", "--arch",
                 "granite-moe-1b-a400m", "--shape", "decode_32k"])
    assert proc.returncode == 0, proc.stderr[-2000:] + proc.stdout[-2000:]
    assert "[ok] granite-moe-1b-a400m x decode_32k" in proc.stdout


def test_skip_policy_is_reported():
    proc = _run(["repro_torch.launch.dryrun", "--arch", "hubert-xlarge",
                 "--shape", "long_500k"])
    assert proc.returncode == 0
    assert "[skip] hubert-xlarge x long_500k" in proc.stdout


def test_importing_the_dry_runs_starts_no_group_and_sets_no_flag():
    code = ("import os, torch.distributed as d, repro_torch.launch.dryrun, "
            "repro_torch.launch.zero_dryrun, repro_torch.launch.fake; "
            "print(d.is_initialized(), 'XLA_FLAGS' in os.environ)")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    env.pop("XLA_FLAGS", None)
    out = subprocess.run([sys.executable, "-c", code], env=env, check=True,
                         capture_output=True, text=True, timeout=120)
    assert out.stdout.split() == ["False", "False"]


def test_a_failing_combination_prints_error_and_exits_non_zero(tmp_path):
    """A combination whose step raises is recorded, printed ``[ERROR]``
    and makes the CLI exit non-zero (here: an accumulation count that
    does not divide the per-device batch)."""
    out = tmp_path / "d.jsonl"
    proc = _run(["repro_torch.launch.dryrun", "--arch", "granite-3-2b",
                 "--shape", "train_4k", "--accum", "3", "--out", str(out)])
    assert proc.returncode != 0
    assert "[ERROR] granite-3-2b x train_4k" in proc.stdout
    assert json.loads(out.read_text())["status"] == "error"


class TestFake:
    def test_live_bytes_counts_allocations_not_views(self):
        with fake.fake_mode():
            base = torch.empty(1000)              # before the window
            with fake.LiveBytes() as live:
                view = base[:10].view(2, 5)       # no allocation
                assert live.live == 0
                x = torch.empty(256)              # 1 KiB
                y = x * 2                         # 1 KiB more
                assert live.live == 2048
                del x, y
                assert live.live == 0
                z = base + 1                      # 4000 B
            assert (live.live, live.peak) == (4000, 4000)
            del view, z

    def test_constant_step_lets_adamw_read_its_count(self):
        with fake.fake_mode():
            params = [torch.empty(10), torch.empty(3, 4)]
            opt = adamw(1e-3)
            state = fake.constant_step(opt.init(params))
            for _ in range(3):
                opt.update([torch.empty(10), torch.empty(3, 4)], state,
                           params)
            assert int(state.step) == 3
            assert type(params[0]).__name__ == "FakeTensor"
