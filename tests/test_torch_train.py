"""repro_torch.optim and repro_torch.train against repro's, on the CPU, and
every family's ``loss_fn`` gradients against ``jax.grad``.

* ``tests/train/test_train_substrate.py`` case for case on the port: the
  optimizer reduces the loss, two accumulated half batches equal one big
  batch (5e-5), the schedule's shape, clipping, int8 compression and its
  error feedback, compressed training, an exact checkpoint round trip, a
  restart after a simulated preemption at step 6 that ends bit for bit
  where an uninterrupted run ends, the data pipeline's determinism, the
  straggler monitor. The port's step writes into the state it is given
  (ROADMAP, divergence 20), so each state here starts from its own clone.
* ``adamw_update``, ``clip_by_global_norm``, ``cosine_schedule`` and
  ``compressed_mean`` against the reference on the same arrays.
* ``loss_fn``'s gradients against ``jax.grad`` of the reference's on each
  family's ``smoke_config`` (float32 compute), weights drawn by the
  reference's (jitted) ``init`` and carried across by
  ``params_from_numpy``: every leaf's largest gap at most 1e-4 of its
  largest reference value. fourier_lm runs under an explicit
  ``fft_variant="stockham"`` on both sides (the reference's ``"auto"``
  reaches ``repro.xfft``, which does not import on jax 0.9.0).
* One train step against the reference's: gradients tight; the updated
  parameters only where |g| is well clear of the gradients' error, since
  Adam's first step is about lr * sign(g).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.models.build import build as jbuild
from repro.optim import adamw as jadamw
from repro.optim import compression as jcomp
from repro.train import loop as jloop
from repro_torch.checkpoint import latest_step, restore, save
from repro_torch.configs import registry as reg
from repro_torch.data.pipeline import SyntheticLM, make_batch
from repro_torch.models.build import build
from repro_torch.models.param import params_from_numpy, tree_leaves, tree_map
from repro_torch.optim import adamw_init, adamw_update, clip_by_global_norm, cosine_schedule
from repro_torch.optim.compression import (
    compress_int8,
    compressed_mean,
    decompress_int8,
    init_error_state,
)
from repro_torch.train.loop import StragglerMonitor, TrainLoop, TrainState, make_train_step

TOL_GRAD = 1e-4
GRAD_ARCHS = ["llama3.2-3b", "mixtral-8x22b", "deepseek-v3-671b", "internvl2-76b",
              "zamba2-2.7b", "xlstm-350m", "whisper-medium", "fourier_lm"]


def _gen(seed=0):
    return torch.Generator().manual_seed(seed)


def _clone(tree):
    return tree_map(torch.clone, tree)


def _state(params):
    params = _clone(params)
    return TrainState(params, adamw_init(params))


@pytest.fixture(scope="module")
def tiny():
    cfg = reg.smoke_config("llama3.2-3b")
    model = build(cfg)
    params = model.init(_gen(0))
    return cfg, model, params


def _batch(cfg, step=0, b=4, s=16):
    return make_batch(cfg, b, s, step, device="cpu")


# ------------- tests/train/test_train_substrate.py, case for case -------------


def test_adamw_reduces_loss(tiny):
    cfg, model, params = tiny
    state = _state(params)
    step = make_train_step(model.loss_fn, peak_lr=1e-2, warmup=2, total=100)
    losses = []
    for _ in range(12):
        state, m = step(state, _batch(cfg, 0))  # same batch -> should overfit
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] * 0.9, losses


def test_grad_accum_matches_big_batch(tiny):
    cfg, model, params = tiny
    b1 = _batch(cfg, 0, b=4)
    # accum=2 over two halves == one step over the full batch
    halves = tree_map(lambda x: x.reshape(2, 2, *x.shape[1:]), b1)
    s_full, s_acc = _state(params), _state(params)
    step_full = make_train_step(model.loss_fn, accum=1, peak_lr=1e-3)
    step_acc = make_train_step(model.loss_fn, accum=2, peak_lr=1e-3)
    s_full, m_full = step_full(s_full, b1)
    s_acc, m_acc = step_acc(s_acc, halves)
    d = [float((a - b).abs().max()) for a, b in zip(tree_leaves(s_full.params),
                                                    tree_leaves(s_acc.params))]
    assert max(d) < 5e-5, m_acc


def test_cosine_schedule_shape():
    s = [float(cosine_schedule(torch.tensor(i), peak_lr=1.0, warmup=10, total=100))
         for i in [0, 5, 10, 50, 100]]
    assert s[0] == 0.0 and s[1] == pytest.approx(0.5)
    assert s[2] == pytest.approx(1.0) and s[3] < 1.0 and s[4] >= 0.1 * 0.99


def test_clip_by_global_norm():
    g = {"a": torch.full((10,), 10.0)}
    clipped, gn = clip_by_global_norm(g, max_norm=1.0)
    assert float(gn) == pytest.approx(np.sqrt(1000.0), rel=1e-5)
    assert float(torch.linalg.norm(clipped["a"])) == pytest.approx(1.0, rel=1e-5)


def test_int8_compression_roundtrip(rng):
    g = torch.from_numpy(rng.standard_normal((128,)).astype(np.float32))
    q, scale = compress_int8(g)
    deq = decompress_int8(q, scale)
    assert q.dtype == torch.int8
    assert float((deq - g).abs().max()) <= float(scale) * 0.5 + 1e-6


def test_error_feedback_accumulates(rng):
    g = torch.from_numpy((rng.standard_normal((64,)) * 1e-4).astype(np.float32))  # tiny grads
    grads = {"w": g}
    err = init_error_state(grads)
    total = torch.zeros_like(g)
    for _ in range(50):
        mean, err = compressed_mean(grads, err)
        total = total + mean["w"]
    # with error feedback the sum of quantised means tracks 50·g
    np.testing.assert_allclose(total.numpy(), (50 * g).numpy(), rtol=0.05, atol=1e-4)


def test_compressed_training_converges(tiny):
    cfg, model, params = tiny
    state = _state(params)
    step = make_train_step(model.loss_fn, peak_lr=1e-2, compress=True)
    losses = []
    for _ in range(12):
        state, m = step(state, _batch(cfg, 0))
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] * 0.9, losses
    assert state.error_fb is not None


def test_checkpoint_exact_roundtrip(tiny, tmp_path):
    cfg, model, params = tiny
    state = _state(params)
    save(str(tmp_path), 7, state.tree(), extra={"note": "x"})
    assert latest_step(str(tmp_path)) == 7
    restored = TrainState.from_tree(restore(str(tmp_path), 7, state.tree()))
    assert all(bool(torch.equal(a, b)) for a, b in zip(tree_leaves(state.params),
                                                       tree_leaves(restored.params)))


def test_preemption_restart_is_bit_identical(tiny, tmp_path):
    """Kill at step 6, restart, and verify the final params match an
    uninterrupted run (data pipeline is (seed, step)-deterministic)."""
    cfg, model, _ = tiny

    def mk_loop(d):
        return TrainLoop(
            model, ckpt_dir=str(d), batch_fn=lambda s: _batch(cfg, s),
            save_every=3, peak_lr=1e-3,
        )

    # uninterrupted
    loop_a = mk_loop(tmp_path / "a")
    loop_a.run(_gen(0), 9)
    state_a, _ = loop_a.init_or_restore(_gen(0))

    # interrupted at 6 (checkpoint exists at 6), then resumed
    loop_b = mk_loop(tmp_path / "b")
    with pytest.raises(RuntimeError, match="simulated preemption"):
        loop_b.run(_gen(0), 9, fail_at=6)
    assert latest_step(str(tmp_path / "b")) == 6
    loop_b2 = mk_loop(tmp_path / "b")
    loop_b2.run(_gen(0), 9)
    state_b, start_b = loop_b2.init_or_restore(_gen(0))

    assert start_b == 9
    d = [float((a - b).abs().max()) for a, b in zip(tree_leaves(state_a.params),
                                                    tree_leaves(state_b.params))]
    assert max(d) == 0.0
    assert sorted(loop_b2.seconds) == [6, 7, 8]


def test_data_pipeline_deterministic():
    p = SyntheticLM(vocab=100, seq=32, batch=4, seed=3, device="cpu")
    a = p.batch_at(5)["tokens"]
    b = p.batch_at(5)["tokens"]
    c = p.batch_at(6)["tokens"]
    assert bool((a == b).all()) and not bool((a == c).all())


def test_straggler_monitor_flags_slow_steps():
    m = StragglerMonitor(threshold=2.0)
    for i in range(10):
        assert not m.record(i, 1.0)
    assert m.record(10, 5.0)
    assert m.flags and m.flags[0][0] == 10


def test_loop_without_a_checkpoint_directory_writes_nothing(tiny, tmp_path, monkeypatch):
    """``ckpt_dir`` empty: nothing restored or written (the launcher's
    ``--ckpt ''``, for full-width runs whose state would not be saved)."""
    cfg, model, _ = tiny
    monkeypatch.chdir(tmp_path)
    loop = TrainLoop(model, ckpt_dir="", batch_fn=lambda s: _batch(cfg, s), save_every=1)
    losses = loop.run(_gen(0), 2)
    assert sorted(losses) == [0, 1] and loop.ckpt is None and not list(tmp_path.iterdir())


# ------------------------ the optimizer against the reference ------------------------


def _tree(rng, dtype=np.float32):
    return {"a": {"w": rng.standard_normal((6, 5)).astype(dtype)},
            "b": rng.standard_normal((7,)).astype(dtype)}


def _rel(got, ref) -> float:
    ref = np.asarray(ref, np.float64)
    return float(np.abs(np.asarray(got, np.float64) - ref).max() / np.abs(ref).max())


@pytest.mark.parametrize("lr", [None, 1e-2])
def test_adamw_update_matches_reference(rng, lr):
    """Three updates of float32 and bf16 parameters (moments float32) from
    the same arrays: parameters and moments to float32 rounding, the step
    counter equal; the port's tensors are written in place."""
    p32 = _tree(rng)
    grads = [_tree(rng) for _ in range(3)]
    jp = jax.tree.map(jnp.asarray, p32)
    jp16 = jax.tree.map(lambda x: jnp.asarray(x, jnp.bfloat16), p32)
    jstate, jstate16 = jadamw.adamw_init(jp), jadamw.adamw_init(jp16)
    p = params_from_numpy(p32, device="cpu")
    p16 = tree_map(lambda x: x.to(torch.bfloat16), p)
    state, state16 = adamw_init(p), adamw_init(p16)
    kw = {"lr": lr, "peak_lr": 1e-2, "warmup": 2, "total": 10}
    for g in grads:
        jp, jstate = jadamw.adamw_update(jp, jax.tree.map(jnp.asarray, g), jstate, **kw)
        jp16, jstate16 = jadamw.adamw_update(jp16, jax.tree.map(jnp.asarray, g), jstate16, **kw)
        tg = params_from_numpy(g, device="cpu")
        before = p["b"]
        p, state = adamw_update(p, tg, state, **kw)
        p16, state16 = adamw_update(p16, tg, state16, **kw)
        assert p["b"] is before  # in place (divergence 20)
    assert int(state["step"]) == int(jstate["step"]) == 3 and state["step"].dtype == torch.int32
    for got, ref in ((p, jp), (state["mu"], jstate["mu"]), (state["nu"], jstate["nu"])):
        for a, b in zip(tree_leaves(got), jax.tree.leaves(ref)):
            assert _rel(a.numpy(), b) <= 1e-6
    for a, b in zip(tree_leaves(p16), jax.tree.leaves(jp16)):
        assert a.dtype == torch.bfloat16
        # one bf16 rounding of the same float32 value, or the next bf16 value
        assert _rel(a.float().numpy(), np.asarray(b, np.float32)) <= 2 ** -7


@pytest.mark.parametrize("max_norm", [1.0, 100.0])
def test_clip_by_global_norm_matches_reference(rng, max_norm):
    g = _tree(rng)
    jclipped, jgn = jadamw.clip_by_global_norm(jax.tree.map(jnp.asarray, g), max_norm)
    clipped, gn = clip_by_global_norm(params_from_numpy(g, device="cpu"), max_norm)
    assert abs(float(gn) - float(jgn)) <= 1e-6 * float(jgn)
    for a, b in zip(tree_leaves(clipped), jax.tree.leaves(jclipped)):
        assert _rel(a.numpy(), b) <= 1e-6


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("max_norm", [0.5, 100.0])
def test_adamw_grad_scale_equals_clipped_tree(rng, dtype, max_norm):
    """The train step's route (``global_norm_scale``'s factor handed to
    ``adamw_update``, each leaf scaled in its own dtype) ends bit for bit
    where stepping on ``clip_by_global_norm``'s tree ends, for float32
    gradients and for the bf16 ones of ``cast_params``."""
    from repro_torch.optim.adamw import global_norm_scale

    p = params_from_numpy(_tree(rng), device="cpu")
    g = tree_map(lambda x: x.to(dtype), params_from_numpy(_tree(rng), device="cpu"))
    clipped, gn = clip_by_global_norm(g, max_norm)
    scale, gn2 = global_norm_scale(g, max_norm)
    assert torch.equal(gn, gn2)
    a, sa = adamw_update(_clone(p), clipped, adamw_init(p), peak_lr=1e-2, warmup=2)
    b, sb = adamw_update(_clone(p), g, adamw_init(p), peak_lr=1e-2, warmup=2, grad_scale=scale)
    leaves = lambda t, s: [*tree_leaves(t), *tree_leaves(s["mu"]), *tree_leaves(s["nu"])]  # noqa: E731
    for x, y in zip(leaves(a, sa), leaves(b, sb), strict=True):
        assert torch.equal(x, y)


def test_cosine_schedule_matches_reference():
    steps = np.arange(0, 130, 3, dtype=np.int32)
    ref = np.asarray(jadamw.cosine_schedule(jnp.asarray(steps), peak_lr=3e-4, warmup=20,
                                            total=120))
    got = cosine_schedule(torch.from_numpy(steps), peak_lr=3e-4, warmup=20, total=120)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6, atol=1e-12)


def test_compressed_mean_matches_reference(rng):
    """Quantised means and error states of five steps from the same
    gradients: the same int8 codes (round half to even on both sides), so
    the means and residuals agree to float32 rounding."""
    g = _tree(rng)
    jg = jax.tree.map(jnp.asarray, g)
    tg = params_from_numpy(g, device="cpu")
    jerr, err = jcomp.init_error_state(jg), init_error_state(tg)
    for _ in range(5):
        jmean, jerr = jcomp.compressed_mean(jg, jerr)
        mean, err = compressed_mean(tg, err)
        for got, ref in ((mean, jmean), (err, jerr)):
            for a, b in zip(tree_leaves(got), jax.tree.leaves(ref)):
                np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-7)
    for x in tree_leaves(tg):
        q, s = compress_int8(x)
        jq, js = jcomp.compress_int8(jnp.asarray(x.numpy()))
        assert np.array_equal(q.numpy(), np.asarray(jq)) and float(s) == float(js)


def test_compressed_mean_averages_over_a_process_group(rng, tmp_path):
    """The reference's ``axis_name`` (a pmean) as a process group: one gloo
    rank, where the all-reduce's mean is its own value."""
    import torch.distributed as dist

    g = params_from_numpy(_tree(rng), device="cpu")
    dist.init_process_group("gloo", store=dist.FileStore(str(tmp_path / "store"), 1), rank=0,
                            world_size=1)
    try:
        grouped, gerr = compressed_mean(g, init_error_state(g), group=dist.group.WORLD)
    finally:
        dist.destroy_process_group()
    alone, err = compressed_mean(g, init_error_state(g))
    for a, b in zip(tree_leaves(grouped) + tree_leaves(gerr), tree_leaves(alone) +
                    tree_leaves(err)):
        assert torch.equal(a, b)


# ------------------------ loss_fn gradients against jax.grad ------------------------


def _batch_for(cfg, rng, b, s):
    if cfg.family == "spectral":
        toks = rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)
        mask = (rng.random((b, s)) < 0.3).astype(np.float32)
        return {"tokens": np.where(mask > 0, 0, toks).astype(np.int32), "targets": toks,
                "mlm_mask": mask}
    out = {"tokens": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)}
    if cfg.family == "audio":
        out["frames"] = (rng.standard_normal((b, cfg.enc_frames, cfg.d_model)) * 0.5).astype(
            np.float32)
    if cfg.family == "vlm":
        out["patches"] = (rng.standard_normal((b, cfg.n_patches, cfg.d_model)) * 0.5).astype(
            np.float32)
    return out


def _models(arch):
    kw = {"fft_variant": "stockham"} if arch == "fourier_lm" else {}
    cfg, jcfg = reg.smoke_config(arch).scaled(**kw), jreg.smoke_config(arch).scaled(**kw)
    jm, m = jbuild(jcfg), build(cfg)
    jp = jax.jit(jm.init)(jax.random.PRNGKey(3))
    return cfg, jm, m, jp, params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")


def _grads(m, p, batch):
    """(loss, grads) of the port's loss_fn by autograd, at the parameters."""
    views = tree_map(lambda x: x.detach().requires_grad_(), p)
    loss, _ = m.loss_fn(views, {k: torch.from_numpy(v) for k, v in batch.items()})
    leaves = tree_leaves(views)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True, materialize_grads=True)
    return float(loss.detach()), grads


@pytest.mark.parametrize("arch", GRAD_ARCHS)
def test_loss_fn_gradients_match_jax_grad(arch):
    cfg, jm, m, jp, p = _models(arch)
    batch = _batch_for(cfg, np.random.default_rng(4), 2, 16 if cfg.family == "spectral" else 14)
    (jloss, _), jg = jax.jit(jax.value_and_grad(jm.loss_fn, has_aux=True))(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    loss, grads = _grads(m, p, batch)
    assert abs(loss - float(jloss)) <= 1e-5 * abs(float(jloss))
    jleaves = jax.tree_util.tree_leaves_with_path(jg)
    assert len(grads) == len(jleaves)
    for (path, ref), got in zip(jleaves, grads):
        ref = np.asarray(ref)
        assert got.shape == ref.shape, jax.tree_util.keystr(path)
        assert _rel(got.numpy(), ref) <= TOL_GRAD, (jax.tree_util.keystr(path),
                                                      _rel(got.numpy(), ref))


def test_train_step_matches_the_reference_step():
    """One step of each package's train step on llama's smoke model from
    the same weights: loss and grad norm tight; the updated parameters
    where |g| exceeds 100x that leaf's largest gradient gap (there Adam's
    first step, about lr * sign(g), has the same sign on both sides)."""
    cfg, jm, m, jp, p = _models("llama3.2-3b")
    batch = _batch_for(cfg, np.random.default_rng(5), 4, 16)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    _, jg = jax.value_and_grad(jm.loss_fn, has_aux=True)(jp, jbatch)
    jstep = jax.jit(jloop.make_train_step(jm.loss_fn, peak_lr=1e-2, warmup=1))
    jstate, jmetrics = jstep(jloop.TrainState(jp, jadamw.adamw_init(jp)), jbatch)
    _, grads = _grads(m, p, batch)
    step = make_train_step(m.loss_fn, peak_lr=1e-2, warmup=1)
    state, metrics = step(TrainState(p, adamw_init(p)),
                          {k: torch.from_numpy(v) for k, v in batch.items()})
    assert abs(float(metrics["loss"]) - float(jmetrics["loss"])) <= 1e-5 * float(jmetrics["loss"])
    assert abs(float(metrics["grad_norm"]) - float(jmetrics["grad_norm"])) <= 1e-5 * float(
        jmetrics["grad_norm"])
    compared = 0
    for got, ref, g, jgl in zip(tree_leaves(state.params), jax.tree.leaves(jstate.params), grads,
                                jax.tree.leaves(jg)):
        g = g.numpy()
        clear = np.abs(g) > 100 * np.abs(g - np.asarray(jgl)).max()
        compared += int(clear.sum())
        np.testing.assert_allclose(got.numpy()[clear], np.asarray(ref)[clear], rtol=1e-5,
                                   atol=1e-6)
    assert compared > 0.5 * sum(g.numel() for g in grads)


# ------------------------------ the launcher ------------------------------


def test_launcher_trains_the_smoke_config_on_the_cpu(tmp_path):
    from repro_torch.launch import train as launch_train

    out = launch_train.main(["--arch", "llama3.2-3b", "--smoke", "--device", "cpu", "--steps",
                             "3", "--batch", "2", "--seq", "16", "--save-every", "2", "--ckpt",
                             str(tmp_path)])
    assert sorted(out["losses"]) == [0, 1, 2] and latest_step(str(tmp_path)) == 3
    assert all(np.isfinite(list(out["losses"].values())))


def test_launcher_distributed_waits_for_the_sharding_slice(monkeypatch):
    """``--distributed`` (the sharding slice has come): without torchrun's
    environment it says what it needs; at world 1 on gloo it trains the
    one process's losses bit for bit and writes the checkpoint from rank 0
    (two ranks: tests/test_torch_sharding.py)."""
    import socket

    from repro_torch.launch import train as launch_train

    for name in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(name, raising=False)
    with pytest.raises(RuntimeError, match="RANK"):
        launch_train.main(["--distributed", "--device", "cpu"])
    args = ["--arch", "llama3.2-3b", "--smoke", "--device", "cpu", "--steps", "2", "--batch",
            "2", "--seq", "16", "--ckpt", ""]
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "1")
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    monkeypatch.setenv("MASTER_PORT", str(port))
    dist = launch_train.main(["--distributed", *args])
    one = launch_train.main(args)
    assert dist["world"] == 1 and dist["losses"] == one["losses"]
    import torch.distributed

    assert not torch.distributed.is_initialized()
