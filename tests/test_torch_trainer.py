"""The port's training loop (``repro_torch.train.Trainer``) against the JAX
package's, on the host: the loss history of the same 12 steps from the
same initial parameters and synthetic data, checkpoint / resume, the
non-finite-step branch, preemption, the straggler monitor, and train ->
checkpoint -> restore into bfloat16 -> serve with the port's ``Engine``
(the twin of ``tests/test_system.py``'s LM round trip).

The loop's model is Qwen2 cut to 2 layers of width 32 (as
``tests/test_substrate.py``'s trainer tests cut it), computing in float32
so that the two frameworks' losses agree to float32 rounding.
"""
import dataclasses
import os
import signal

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.configs.base import get_config as j_get_config  # noqa: E402
from repro.data import DataConfig as JDataConfig  # noqa: E402
from repro.data import IndexedDataset as JIndexedDataset  # noqa: E402
from repro.optim import OptConfig as JOptConfig  # noqa: E402
from repro.train import LoopConfig as JLoopConfig  # noqa: E402
from repro.train import TrainConfig as JTrainConfig  # noqa: E402
from repro.train import Trainer as JTrainer  # noqa: E402

from repro_torch.checkpoint import Checkpointer  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data import DataConfig, IndexedDataset  # noqa: E402
from repro_torch.models import api  # noqa: E402
from repro_torch.optim import OptConfig  # noqa: E402
from repro_torch.serve import Engine, Request, ServeConfig  # noqa: E402
from repro_torch.train import (HeartbeatMonitor, LoopConfig,  # noqa: E402
                               TrainConfig, Trainer)
from repro_torch.tree import leaves, tree_map  # noqa: E402
from repro_torch.weights import lm_params_from_numpy  # noqa: E402

from test_torch_hybrid import numpy_params  # noqa: E402

SMALL = dict(n_layers=2, d_model=32, n_heads=2, n_kv_heads=1, d_ff=64,
             vocab=64, compute_dtype="float32")
OPT = dict(lr=1e-2, warmup_steps=2, total_steps=12)
DATA = dict(kind="lm", vocab=64, seq_len=16, global_batch=4, seed=5)
#: float32 sums in another order than XLA's, over 12 AdamW steps
RTOL = 1e-4



@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The models here are tiny: one intra-op thread runs them faster than
    eight contending with the other test workers' threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

def _weights():
    return numpy_params(dataclasses.replace(j_get_config("qwen2-0.5b"),
                                            **SMALL), 0)


def jax_trainer(path, total_steps=12, ckpt_every=4):
    cfg = dataclasses.replace(j_get_config("qwen2-0.5b"), **SMALL)
    weights = _weights()
    return JTrainer(cfg, JTrainConfig(opt=JOptConfig(**OPT)),
                    JLoopConfig(total_steps=total_steps, ckpt_every=ckpt_every,
                                ckpt_dir=str(path), log_every=0),
                    JIndexedDataset(JDataConfig(**DATA)),
                    init_params_fn=lambda key: jax.tree_util.tree_map(
                        jnp.asarray, weights))


def port_trainer(path, total_steps=12, ckpt_every=4):
    cfg = dataclasses.replace(get_config("qwen2-0.5b"), **SMALL)
    weights = _weights()
    return Trainer(cfg, TrainConfig(opt=OptConfig(**OPT)),
                   LoopConfig(total_steps=total_steps, ckpt_every=ckpt_every,
                              ckpt_dir=str(path), log_every=0),
                   IndexedDataset(DataConfig(**DATA)),
                   init_params_fn=lambda gen: lm_params_from_numpy(
                       weights, device=gen.device),
                   device="cpu")


def _losses(hist):
    return [h["loss"] for h in hist]


def test_loss_history_matches_jax(tmp_path):
    _, _, jstep, jhist = jax_trainer(tmp_path / "jax").run()
    params, opt, step, hist = port_trainer(tmp_path / "port").run()
    assert step == jstep == 12
    assert [h["step"] for h in hist] == [h["step"] for h in jhist] \
        == list(range(12))
    np.testing.assert_allclose(_losses(hist), _losses(jhist), rtol=RTOL)
    np.testing.assert_allclose([h["grad_norm"] for h in hist],
                               [h["grad_norm"] for h in jhist], rtol=RTOL)
    assert hist[-1]["loss"] < hist[0]["loss"] + 0.5     # JAX's own gate
    assert int(opt["step"]) == 12
    assert all(p.requires_grad for p in leaves(params))


def test_resume_reproduces_the_straight_run(tmp_path):
    """6 steps, a new trainer restored from the step-6 checkpoint, 6 more:
    the losses of the straight 12-step run."""
    _, _, _, full = port_trainer(tmp_path / "a", ckpt_every=6).run()
    port_trainer(tmp_path / "b", total_steps=6, ckpt_every=6).run()
    tr = port_trainer(tmp_path / "b", ckpt_every=6)
    params, opt, start = tr.init_or_restore()
    assert start == 6 and int(opt["step"]) == 6
    _, _, _, tail = tr.run(params, opt, start)
    assert [h["step"] for h in tail] == list(range(6, 12))
    np.testing.assert_allclose(_losses(tail), _losses(full)[6:], rtol=RTOL,
                               atol=1e-5)


def _poison_third_step(tr, poison):
    """Make the trainer's third step start from a parameter tree whose
    final norm is NaN: its loss is not finite."""
    inner, calls = tr.step_fn, [0]

    def step(params, opt_state, batch):
        calls[0] += 1
        if calls[0] == 3:
            params = dict(params, final_norm=poison(params["final_norm"]))
        return inner(params, opt_state, batch)
    tr.step_fn = step


def test_nonfinite_step_mirrors_jax(tmp_path):
    """Step 2's loss is NaN: both loops count it as skipped, keep it out
    of the history, find the updated parameters non-finite and restore
    the step-2 checkpoint, then go on to the same losses."""
    jtr = jax_trainer(tmp_path / "jax", total_steps=6, ckpt_every=2)
    _poison_third_step(jtr, lambda x: x * jnp.nan)
    _, _, _, jhist = jtr.run()
    tr = port_trainer(tmp_path / "port", total_steps=6, ckpt_every=2)

    def nan_norm(x):
        with torch.no_grad():
            x.fill_(float("nan"))
        return x
    _poison_third_step(tr, nan_norm)
    params, _, _, hist = tr.run()
    assert tr.skipped == jtr.skipped == 1
    assert [h["step"] for h in hist] == [h["step"] for h in jhist] \
        == [0, 1, 3, 4, 5]
    np.testing.assert_allclose(_losses(hist), _losses(jhist), rtol=RTOL)
    assert all(bool(torch.isfinite(p).all()) for p in leaves(params))


def test_sigterm_saves_and_returns(tmp_path):
    """After install_preemption_handler, a SIGTERM during step 2 makes the
    loop save a blocking checkpoint at step 3 and return."""
    tr = port_trainer(tmp_path, ckpt_every=100)
    prev = signal.getsignal(signal.SIGTERM)
    tr.install_preemption_handler()
    inner, calls = tr.step_fn, [0]

    def step(*args):
        calls[0] += 1
        if calls[0] == 3:
            os.kill(os.getpid(), signal.SIGTERM)
        return inner(*args)
    tr.step_fn = step
    try:
        _, _, step_at, hist = tr.run()
    finally:
        signal.signal(signal.SIGTERM, prev)
    assert step_at == 3 and len(hist) == 3
    assert Checkpointer(str(tmp_path)).all_steps() == [3]


def test_heartbeat_straggler_detection():
    mon = HeartbeatMonitor(factor=3.0)
    for _ in range(10):
        mon.beat(0.1)
    assert mon.beat(0.5) is True
    assert mon.stragglers == 1
    assert mon.beat(0.11) is False


def test_loop_config_names_its_checkpoint_directory():
    """LoopConfig has no default ckpt_dir: a Trainer resumes from any
    checkpoint it finds there, so a shared default could resume another
    run's."""
    with pytest.raises(TypeError, match="ckpt_dir"):
        LoopConfig(total_steps=2)
    assert LoopConfig(ckpt_dir="x").ckpt_dir == "x"


def test_lm_train_checkpoint_serve_roundtrip(tmp_path):
    """Train a reduced LM from the port's own seeded init, checkpoint,
    restore into bfloat16, serve 3 requests batched."""
    cfg = dataclasses.replace(get_config("granite-3-2b"), n_layers=2,
                              d_model=32, n_heads=4, n_kv_heads=2, d_ff=64,
                              vocab=64)
    ds = IndexedDataset(DataConfig(kind="lm", vocab=64, seq_len=16,
                                   global_batch=4, seed=2))
    tr = Trainer(cfg, TrainConfig(opt=OptConfig(lr=1e-2, warmup_steps=1,
                                                total_steps=8)),
                 LoopConfig(total_steps=8, ckpt_every=8,
                            ckpt_dir=str(tmp_path), log_every=0),
                 ds, init_params_fn=lambda gen: api.init_params(
                     cfg, gen, device="cpu"), device="cpu")
    params, _, step, hist = tr.run()
    assert step == 8 and hist[-1]["loss"] < hist[0]["loss"] + 0.5

    bf16_like = tree_map(lambda x: torch.zeros(
        x.shape, dtype=torch.bfloat16 if x.is_floating_point()
        else x.dtype), params)
    tree, got_step = Checkpointer(str(tmp_path)).restore(
        {"params": bf16_like, "opt": tr.init_or_restore()[1]})
    assert got_step == 8
    assert all(p.dtype == torch.bfloat16 for p in leaves(tree["params"]))
    eng = Engine(cfg, tree["params"], ServeConfig(max_batch=2, max_len=32))
    for i in range(3):
        eng.submit(Request(uid=i, prompt=np.arange(4, dtype=np.int32),
                           max_new_tokens=3))
    done = eng.run_until_drained()
    assert len(done) == 3 and all(len(r.out_tokens) == 3 for r in done)
    assert all(r.status == "ok" for r in done)
