"""The command-line driver of the torch port (``main.py``, ``config.py``)
against the JAX package's, on the CPU (``device="cpu"``).

* ``RunConfig``: a JSON file of the JAX ``RunConfig`` loads with every
  field equal; the parser offers every JAX flag, plus ``--device``.
* ``build_potential``: value and gradient of every builtin and of the
  example models with the JSON data of ``examples/`` at the same numpy
  positions, to rtol 1e-5 (atol 1e-5 for values near 0).
* ``run``: the same summary keys as the JAX ``run`` on the same config,
  posterior moments within Monte-Carlo error of each other (W = 256 x 100
  draws; limits stated at each test).
* Checkpointed runs of hmc, nuts, chees, pt and smc, resumed, end bitwise
  in the state of the uninterrupted run (and of the ``run_*`` call with
  the run's seed and initial positions).
"""

import contextlib
import dataclasses
import io
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from physicsbasedbayesianinference_tpu import config as jconfig
from physicsbasedbayesianinference_tpu import diagnostics as jdiag
from physicsbasedbayesianinference_tpu import main as jmain
from physicsbasedbayesianinference_tpu import native as jnative
from physicsbasedbayesianinference_tpu.ops import potentials as jp
import physicsbasedbayesianinference_tpu_torch as pt
from physicsbasedbayesianinference_tpu_torch import config as tconfig
from physicsbasedbayesianinference_tpu_torch import diagnostics as tdiag
from physicsbasedbayesianinference_tpu_torch import main as tmain
from physicsbasedbayesianinference_tpu_torch.checkpoint import (
    CheckpointManager)
from physicsbasedbayesianinference_tpu_torch.ops import potentials as tp

ROOT = Path(__file__).resolve().parent.parent
EXAMPLES = ROOT / "examples"


def _cfg(**kw):
    return tconfig.RunConfig(device="cpu", **kw)


def _quiet(fn, *args):
    """``fn(*args)`` with its progress lines on standard error kept."""
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        out = fn(*args)
    return out, err.getvalue()


# ---------------------------------------------------------------------------
# RunConfig and the parser
# ---------------------------------------------------------------------------


def test_a_jax_config_file_loads_in_the_port(tmp_path):
    jcfg = jconfig.RunConfig(model="example:eight_schools", sampler="pt",
                             num_walkers=64, smc_beta0=0.25, adapt_mass=False,
                             checkpoint_dir="ck", output_path="o.npz")
    path = tmp_path / "run.json"
    path.write_text(jcfg.to_json())
    tcfg = tconfig.RunConfig.from_file(str(path))
    for f in dataclasses.fields(jconfig.RunConfig):
        assert getattr(tcfg, f.name) == getattr(jcfg, f.name), f.name
    assert tcfg.kernel == "auto" and tcfg.device == "cuda"
    assert tconfig.RunConfig.from_json(tcfg.to_json()) == tcfg
    # and the port's file, less its device, loads in the JAX package
    data = json.loads(tcfg.to_json())
    del data["device"]
    assert jconfig.RunConfig.from_json(json.dumps(data)) == jcfg


def test_config_refusals():
    with pytest.raises(ValueError, match="unknown config keys"):
        tconfig.RunConfig.from_json('{"num_walkers": 4, "bogus": 1}')
    with pytest.raises(ValueError, match="composed"):
        tconfig.RunConfig(kernel="xla")
    # sharded=True runs hmc with the diagonal metric; the rest is refused,
    # naming what is missing
    assert tconfig.RunConfig(sharded=True).sharded
    for bad, named in ((dict(sampler="chees"), "sampler='chees'"),
                       (dict(metric="dense"), "metric='dense'"),
                       (dict(checkpoint_dir="ck"), "checkpoint_dir"),
                       (dict(collect="stream"), "collect='stream'")):
        with pytest.raises(ValueError, match=f"{named}.*not ported yet"):
            tconfig.RunConfig(sharded=True, **bad)
    with pytest.raises(ValueError, match="numpyro"):
        tmain.build_potential(_cfg(model="numpyro:mod:fn"))
    with pytest.raises(ValueError, match="bad model reference"):
        tmain.build_potential(_cfg(model="nonsense"))
    with pytest.raises(ValueError, match="unknown builtin"):
        tmain.build_potential(_cfg(model="builtin:nope"))


def test_without_a_card_the_run_needs_device_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device='cuda' runs")
    with pytest.raises(ValueError, match="--device cpu"):
        tmain.run(tconfig.RunConfig(num_walkers=8, num_warmup=1,
                                    num_samples=1))


def test_the_parser_offers_every_jax_flag():
    def flags(parser):
        return {s for a in parser._actions for s in a.option_strings}
    jflags, tflags = flags(jmain._build_parser()), flags(
        tmain._build_parser())
    assert jflags <= tflags
    assert tflags - jflags == {"--device"}
    args = tmain._build_parser().parse_args(
        ["--adapt-mass", "false", "--num-walkers", "8", "--pt-beta-min",
         "0.1", "--data", "x.json", "--device", "cpu"])
    assert (args.adapt_mass, args.num_walkers, args.pt_beta_min,
            args.data_path, args.device) == (False, 8, 0.1, "x.json", "cpu")


# ---------------------------------------------------------------------------
# build_potential
# ---------------------------------------------------------------------------

MODELS = ["builtin:std_normal_2d", "builtin:std_normal_32d",
          "builtin:banana", "builtin:funnel_10d", "builtin:bimodal_2d",
          "example:coin_toss", "example:eight_schools",
          "example:eight_schools_noncentered"]
DATA = {"example:coin_toss": "coin_toss.data.json",
        "example:eight_schools": "eight_schools.data.json",
        "example:eight_schools_noncentered": "eight_schools.data.json"}


@pytest.mark.parametrize("model", MODELS)
def test_build_potential_matches_jax(model):
    data = DATA.get(model)
    kw = dict(model=model,
              data_path=str(EXAMPLES / data) if data else None)
    jfn, jinit, _ = jmain.build_potential(jconfig.RunConfig(**kw))
    tfn, tinit, _ = tmain.build_potential(_cfg(**kw))
    d = tinit(0, 4).shape[1]
    assert np.asarray(jinit(jax.random.key(0), 4)).shape == (4, d)
    q = (0.7 * np.random.default_rng(3).normal(size=(16, d))).astype(
        np.float32)
    uj, gj = jp.batched_value_and_grad(jfn)(jnp.asarray(q))
    ut, gt = tp.batched_value_and_grad(tfn)(torch.as_tensor(q))
    np.testing.assert_allclose(ut.numpy(), np.asarray(uj), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(gt.numpy(), np.asarray(gj), rtol=1e-5,
                               atol=1e-5)


# ---------------------------------------------------------------------------
# run: the same summary as the JAX package's
# ---------------------------------------------------------------------------

RUNS = {
    "hmc": dict(model="builtin:std_normal_2d", sampler="hmc", num_steps=8),
    "chees": dict(model="builtin:std_normal_2d", sampler="chees",
                  collect="moments"),
    "pt": dict(model="builtin:std_normal_2d", sampler="pt", pt_replicas=3,
               num_steps=6, collect="moments"),
    "nuts": dict(model="builtin:std_normal_2d", sampler="nuts", max_depth=5),
    "coin_toss": dict(model="example:coin_toss", sampler="hmc", num_steps=8,
                      data_path=str(EXAMPLES / "coin_toss.data.json")),
}


@pytest.mark.parametrize("name", sorted(RUNS))
def test_run_matches_jax(name):
    """Within Monte-Carlo error: 256 walkers x 100 draws, each walker's
    draws counted as ~10 independent ones, so the standard errors of the
    mean and variance of N(0, 1) are 0.02 and 0.028; the gates (0.12,
    0.17) are six of them, against the closed form and between the
    packages."""
    kw = dict(num_walkers=256, num_warmup=100, num_samples=100, seed=3,
              **RUNS[name])
    sj, _ = _quiet(jmain.run, jconfig.RunConfig(**kw))
    st, err = _quiet(tmain.run, _cfg(**kw))
    assert set(st) == set(sj)
    assert st["config"] == dict(sj["config"], device="cpu")
    assert "# launches" in err
    if name == "coin_toss":
        for k in ("p1", "p2"):
            assert abs(st["constrained_means"][k]
                       - sj["constrained_means"][k]) < 0.05
        return
    mean_t, mean_j = (np.asarray(s["posterior_mean"]) for s in (st, sj))
    spread = ("posterior_var" if "posterior_var" in st else "posterior_sd")
    var_t, var_j = (np.asarray(s[spread]) for s in (st, sj))
    if spread == "posterior_sd":
        var_t, var_j = var_t**2, var_j**2
    for m, v in ((mean_t, var_t), (mean_j, var_j)):
        np.testing.assert_allclose(m, 0.0, atol=0.12)
        np.testing.assert_allclose(v, 1.0, atol=0.17)
    np.testing.assert_allclose(mean_t, mean_j, atol=0.17)
    if "min_ess" in st:
        assert st["min_ess"] > 0 and st["max_rhat"] < 1.1


def test_smc_summary_has_no_ess_for_one_ensemble():
    """SMC returns one ensemble: no ESS or R-hat (the JAX summary divides
    by zero there), the rest of the summary as the JAX checkpointed SMC
    reports it."""
    st, _ = _quiet(tmain.run, _cfg(
        model="builtin:std_normal_2d", sampler="smc", num_walkers=128,
        num_steps=4, smc_beta0=0.1, smc_max_stages=6))
    assert st["min_ess"] is None and st["max_rhat"] is None
    assert np.isfinite(st["log_evidence"]) and st["num_stages"] >= 1
    np.testing.assert_allclose(st["posterior_mean"], 0.0, atol=0.4)


# ---------------------------------------------------------------------------
# Checkpointed runs: resumed, bitwise the uninterrupted run
# ---------------------------------------------------------------------------

CHECKPOINTED = {
    "hmc": dict(model="builtin:std_normal_2d", num_steps=4),
    "nuts": dict(model="builtin:std_normal_2d", max_depth=4),
    "chees": dict(model="example:eight_schools_noncentered",
                  data_path=str(EXAMPLES / "eight_schools.data.json")),
    "pt": dict(model="builtin:bimodal_2d", pt_replicas=3, num_steps=4),
}


def _final_state(cfg, sampler, template):
    mgr = CheckpointManager(cfg.checkpoint_dir)
    return mgr.restore({"schema": 0, "state": template,
                        "step_size": torch.zeros(
                            (cfg.pt_replicas,) if sampler == "pt" else ()),
                        "tau": torch.zeros(()), "mean": torch.zeros(
                            template["q"].shape[-1] if sampler == "pt"
                            else template.ensemble.q.shape[-1]),
                        "m2": torch.zeros(
                            template["q"].shape[-1] if sampler == "pt"
                            else template.ensemble.q.shape[-1]),
                        "n": 0})


@pytest.mark.parametrize("sampler", sorted(CHECKPOINTED))
def test_checkpointed_resume_is_bitwise(tmp_path, sampler):
    base = dict(sampler=sampler, num_walkers=64, num_warmup=30,
                checkpoint_every=8, seed=5, **CHECKPOINTED[sampler])
    a = _cfg(checkpoint_dir=str(tmp_path / "a"), num_samples=16, **base)
    s1, _ = _quiet(tmain.run, a)
    assert (s1["resumed_from"], s1["samples_done"],
            s1["checkpoints_written"]) == (None, 16, 2)
    # a longer run against the same directory resumes at 16, and its last
    # chunk is cut to the count (8 + 6)
    a = dataclasses.replace(a, num_samples=30)
    s2, err = _quiet(tmain.run, a)
    assert "resumed from checkpoint step 16" in err
    assert (s2["resumed_from"], s2["samples_done"],
            s2["checkpoints_written"]) == (16, 30, 2)
    b = dataclasses.replace(a, checkpoint_dir=str(tmp_path / "b"))
    s3, _ = _quiet(tmain.run, b)
    for key in ("posterior_mean", "posterior_var", "step_size"):
        assert s2[key] == s3[key], key

    # the uninterrupted run_* call with the run's seed and init
    inputs = tmain.prepare(a)
    kw = dict(num_warmup=30, num_samples=30, init_step_size=0.1)
    if sampler == "hmc":
        ref = pt.run_hmc(inputs.seed, inputs.potential, inputs.init_q,
                         num_steps=4, collect="moments", **kw)
        ref_q, template = ref.state.ensemble.q, ref.state
    elif sampler == "nuts":
        ref = pt.run_nuts(inputs.seed, inputs.potential, inputs.init_q,
                          max_depth=4, collect="none", **kw)
        ref_q, template = ref.state.ensemble.q, ref.state
    elif sampler == "chees":
        ref = pt.run_chees_hmc(inputs.seed, inputs.potential, inputs.init_q,
                               collect="moments", **kw)
        ref_q, template = ref.state.ensemble.q, ref.state
    else:
        ref = pt.run_parallel_tempering(
            inputs.seed, inputs.potential, inputs.init_q, num_replicas=3,
            num_steps=4, collect="moments", **kw)
        ref_q, template = ref.q, {"q": ref.q, "u": ref.u, "g": ref.g}
    for cfg in (a, b):
        final = _final_state(cfg, sampler, template)["state"]
        q = final["q"] if sampler == "pt" else final.ensemble.q
        assert torch.equal(q, ref_q)
    if getattr(ref, "mean", None) is not None:
        assert s2["posterior_mean"] == ref.mean.tolist()
        assert s2["posterior_var"] == ref.var.tolist()


def test_checkpointed_smc_resumes_from_any_stage_bitwise(tmp_path):
    base = dict(model="builtin:std_normal_32d", sampler="smc",
                num_walkers=128, num_steps=4, smc_beta0=0.02,
                smc_max_stages=25, seed=3)
    a = tmp_path / "a"
    s1, _ = _quiet(tmain.run, _cfg(checkpoint_dir=str(a), **base))
    assert s1["resumed_from"] is None
    assert s1["checkpoints_written"] == s1["num_stages"] >= 3
    stages = sorted(int(p.name) for p in a.iterdir() if p.name.isdigit())
    assert len(stages) == 3 and stages[-1] == s1["num_stages"]
    b = tmp_path / "b"
    b.mkdir()
    shutil.copytree(a / str(stages[0]), b / str(stages[0]))
    s2, _ = _quiet(tmain.run, _cfg(checkpoint_dir=str(b), **base))
    assert s2["resumed_from"] == stages[0]
    for key in ("num_stages", "log_evidence", "posterior_mean",
                "posterior_var", "final_step_size"):
        assert s2[key] == s1[key], key
    inputs = tmain.prepare(_cfg(**base))
    ref = pt.run_smc(inputs.seed, inputs.potential, inputs.init_q,
                     num_mutation_steps=3, num_leapfrog_steps=4,
                     init_step_size=0.1, beta0=0.02, max_stages=25)
    assert float(ref.log_evidence) == s1["log_evidence"]
    # a finished run resumed again runs no stage
    s3, _ = _quiet(tmain.run, _cfg(checkpoint_dir=str(a), **base))
    assert s3["checkpoints_written"] == 0
    assert s3["log_evidence"] == s1["log_evidence"]


@pytest.mark.parametrize("mode", ["checkpointed hmc", "checkpointed smc",
                                  "stream"])
def test_checkpointed_and_stream_summaries_have_the_jax_keys(tmp_path, mode):
    kw = dict(model="builtin:std_normal_2d", num_walkers=32, num_warmup=10,
              num_samples=8, num_steps=2)
    if mode == "checkpointed hmc":
        kw.update(checkpoint_every=4)
    elif mode == "checkpointed smc":
        kw.update(sampler="smc", smc_beta0=0.2, smc_max_stages=3)
    else:
        kw.update(collect="stream")
    summaries = []
    for name, run, config in (("j", jmain.run, jconfig.RunConfig),
                              ("t", tmain.run, _cfg)):
        where = str(tmp_path / name)
        paths = (dict(output_path=where + ".pbbi") if mode == "stream"
                 else dict(checkpoint_dir=where))
        summaries.append(_quiet(run, config(**kw, **paths))[0])
    assert set(summaries[1]) == set(summaries[0])


def test_a_checkpoint_of_another_config_is_refused(tmp_path):
    base = dict(model="builtin:std_normal_2d", sampler="hmc",
                num_walkers=16, num_warmup=4, num_samples=4, num_steps=2,
                checkpoint_dir=str(tmp_path))
    _quiet(tmain.run, _cfg(**base))
    with pytest.raises(RuntimeError, match="schema"):
        _quiet(tmain.run, _cfg(**dict(base, num_walkers=17,
                                      num_samples=8)))
    with pytest.raises(ValueError, match="dense"):
        _quiet(tmain.run, _cfg(**dict(base, metric="dense",
                                      checkpoint_dir=str(tmp_path / "d"))))


# ---------------------------------------------------------------------------
# Stream mode and the command line
# ---------------------------------------------------------------------------


def test_stream_mode_writes_what_run_hmc_draws(tmp_path):
    out = str(tmp_path / "stream.pbbi")
    cfg = _cfg(model="builtin:std_normal_2d", num_walkers=128,
               num_warmup=60, num_samples=20, num_steps=4, thin=3,
               collect="stream", output_path=out)
    s, _ = _quiet(tmain.run, cfg)
    assert s["streamed_rows"] == 20 * 128
    data = np.asarray(jnative.read_samples(out))  # the JAX reader
    assert data.shape == (20 * 128, 2)
    np.testing.assert_allclose(data.mean(0), 0.0, atol=0.15)
    np.testing.assert_allclose(data.std(0), 1.0, atol=0.15)
    # row block i is the state after sampling transition 3 (i + 1) of the
    # uninterrupted run_hmc
    inputs = tmain.prepare(cfg)
    ref = pt.run_hmc(inputs.seed, inputs.potential, inputs.init_q,
                     num_warmup=60, num_samples=60, num_steps=4, thin=1)
    np.testing.assert_array_equal(
        data.reshape(20, 128, 2), ref.samples[2::3].numpy())
    with pytest.raises(ValueError, match="stream"):
        _quiet(tmain.run, dataclasses.replace(cfg, sampler="nuts"))


def test_the_command_line(tmp_path):
    out = tmp_path / "run.npz"
    proc = subprocess.run(
        [sys.executable, "-m", "physicsbasedbayesianinference_tpu_torch.main",
         "--model", "builtin:banana", "--num-walkers", "64",
         "--num-warmup", "20", "--num-samples", "10", "--num-steps", "4",
         "--device", "cpu", "--output-path", str(out)],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=str(ROOT)))
    assert proc.returncode == 0, proc.stderr
    summary = json.loads(proc.stdout)
    assert summary["kernel_used"] == "composed"
    assert summary["config"]["device"] == "cpu"
    launches = json.loads(proc.stderr.split("# launches ")[1].splitlines()[0])
    assert sum(v for k, v in launches.items() if isinstance(v, int)) == 0
    with np.load(out, allow_pickle=False) as data:
        assert data["samples"].shape == (10, 64, 2)
        assert json.loads(str(data["summary"]))["accept_rate"] == \
            summary["accept_rate"]


def test_metrics_logger_and_wall_clock_print_the_jax_strings():
    series = {"accept": np.linspace(0.5, 0.9, 7).astype(np.float32),
              "step": np.arange(7)}
    lines_j, lines_t = [], []
    jdiag.MetricsLogger(every=3, sink=lines_j.append).log_series(
        {k: jnp.asarray(v) for k, v in series.items()})
    tdiag.MetricsLogger(every=3, sink=lines_t.append).log_series(
        {k: torch.as_tensor(v) for k, v in series.items()})
    assert lines_t == lines_j and len(lines_t) == 3
    for logger, sink in ((jdiag.MetricsLogger(2, lines_j.append), lines_j),
                         (tdiag.MetricsLogger(2, lines_t.append), lines_t)):
        logger.log(4, {"name": "chees", "x": 1.5})
        logger.log(5, {"x": 2.0})
    assert lines_t == lines_j and lines_t[-1] == "step=4  name=chees  x=1.5"
    clock = []
    with tdiag.wall_clock("warmup", clock.append):
        pass
    assert clock[0].startswith("[warmup] ") and clock[0].endswith("s")
    with tdiag.trace_annotation("chunk"):
        pass
