"""repro_torch's LM ServeEngine and launcher against repro's, on the CPU.

``repro.serve.engine.ServeEngine`` runs on this jax (under ``jax.jit``), so
the same queue goes through the reference's engine and the port's on the
same weights, drawn by the reference and carried by ``params_from_numpy``,
and must give the same tokens, token for token (float32 compute; the
logits agree to 1e-4 of their largest value, tests/test_torch_models.py,
test_torch_xlstm.py and test_torch_ssm.py, and greedy argmax takes no
tolerance). The reference's ``tests/serve/test_engine.py`` is ported one
for one. The port writes its caches in place, so each lane batch must
start from the caches ``init_cache_fn`` makes (recurrent states too).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import obs as jobs
from repro.configs import registry as jreg
from repro.models.build import build as jbuild
from repro.resilience import Overloaded as JOverloaded
from repro.resilience import ServicePolicy as JServicePolicy
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServeEngine as JServeEngine
from repro_torch import obs
from repro_torch.configs import registry as reg
from repro_torch.data.pipeline import patches_for
from repro_torch.launch import serve as launch_serve
from repro_torch.models.build import build
from repro_torch.models.param import params_from_numpy
from repro_torch.models.param import tree_leaves as param_tree_leaves
from repro_torch.resilience import Overloaded, ServicePolicy
from repro_torch.serve import Request, ServeEngine


@pytest.fixture(scope="module")
def engine():
    cfg = reg.smoke_config("llama3.2-3b")
    model = build(cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    return cfg, model, params, ServeEngine(model, params, batch=2, max_len=64)


# ---------------- tests/serve/test_engine.py, one for one ----------------


def test_greedy_generation_shapes(engine):
    cfg, model, params, eng = engine
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, (8,)).astype(np.int32) for _ in range(2)]
    outs = eng.generate(prompts, max_new=6)
    assert len(outs) == 2 and all(len(o) == 6 for o in outs)
    assert all(0 <= t < cfg.vocab for o in outs for t in o)


def test_generation_matches_step_by_step_forward(engine):
    """Engine output == logits argmax of repeated full forwards (no cache)."""
    cfg, model, params, eng = engine
    rng = np.random.default_rng(1)
    prompt = rng.integers(0, cfg.vocab, (8,)).astype(np.int32)
    outs = eng.generate([prompt, prompt], max_new=4)

    seq = list(prompt)
    ref = []
    for _ in range(4):
        caches = model.init_cache_fn(1, 64, torch.float32, "cpu")
        logits, _ = model.prefill_fn(
            params, {"tokens": torch.tensor([seq], dtype=torch.int32)}, caches
        )
        t = int(torch.argmax(logits[0]))
        ref.append(t)
        seq.append(t)
    assert outs[0] == ref, (outs[0], ref)


def test_continuous_batching_queue(engine):
    cfg, model, params, eng = engine
    rng = np.random.default_rng(2)
    queue = [
        Request(prompt=rng.integers(0, cfg.vocab, (6,)).astype(np.int32), max_new=3)
        for _ in range(5)  # 5 requests through 2 slots
    ]
    done = eng.serve_queue(list(queue))
    assert len(done) == 5
    assert all(r.done and len(r.out) == 3 for r in done)


def test_prompt_length_buckets_group_into_lanes(engine):
    """Mixed prompt lengths split into pow2 buckets, so a short prompt is
    never padded to an unrelated long one in its batch."""
    cfg, model, params, eng = engine
    rng = np.random.default_rng(3)
    short = [
        Request(prompt=rng.integers(0, cfg.vocab, (4,)).astype(np.int32), max_new=2)
        for _ in range(2)
    ]
    long = [
        Request(prompt=rng.integers(0, cfg.vocab, (30,)).astype(np.int32), max_new=2)
        for _ in range(2)
    ]
    with obs.capture() as trace:
        done = eng.serve_queue(short + long)
    assert len(done) == 4 and all(r.done for r in done)
    q = trace.first("serve.queue")
    assert q["service"] == "lm" and q["lanes"] == 2
    batches = sorted(e["prompt_len"] for e in trace.select("serve.batch"))
    assert batches == [4, 30]  # short batch padded to 4, not to 30


def test_oversized_prompt_rejected(engine):
    cfg, model, params, eng = engine
    too_long = Request(prompt=np.zeros((65,), np.int32))  # max_len is 64
    with pytest.raises(ValueError, match="request 0: prompt length"):
        eng.serve_queue([too_long])


# --------------------- the reference's tokens, carried ---------------------


def _pair(arch, batch, max_len, seed=0, policy=None):
    jcfg, cfg = jreg.smoke_config(arch), reg.smoke_config(arch)
    jm, m = jbuild(jcfg), build(cfg)
    jp = jm.init(jax.random.PRNGKey(seed))
    p = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    jeng = JServeEngine(jm, jp, batch=batch, max_len=max_len,
                        policy=None if policy is None else JServicePolicy(**policy))
    eng = ServeEngine(m, p, batch=batch, max_len=max_len,
                      policy=None if policy is None else ServicePolicy(**policy))
    return cfg, jeng, eng


def _queue(cfg, lengths, seed, cls):
    rng = np.random.default_rng(seed)
    return [cls(prompt=rng.integers(0, cfg.vocab, (n,)).astype(np.int32), max_new=2 + i % 4)
            for i, n in enumerate(lengths)]


@pytest.mark.parametrize("arch", ["llama3.2-3b", "starcoder2-3b", "glm4-9b", "internvl2-76b",
                                  "xlstm-350m", "zamba2-2.7b", "mixtral-8x22b",
                                  "deepseek-v3-671b"])
def test_serve_queue_gives_the_reference_tokens(arch):
    """Mixed prompt lengths over several lanes, left-padded in each, and
    (internvl2) patch embeddings prepended: token for token. xlstm's and
    zamba2's caches are recurrent states (and zamba2's shared-block KV
    caches); xlstm's only match once every lane batch starts its
    stabilisers at −inf again. mixtral's prompts of 9 to 30 tokens pass
    its ring of 8 (the reference's slots kept); deepseek's caches are
    MLA's latents, its prefills drop over-capacity assignments."""
    cfg, jeng, eng = _pair(arch, batch=3, max_len=64)
    lengths = [3, 5, 8, 12, 17, 30, 6, 9]
    jextras = extras = None
    if cfg.family == "vlm":
        patches = patches_for(cfg, 3, 0, device="cpu")
        jextras, extras = {"patches": jnp.asarray(patches.numpy())}, {"patches": patches}
    ref = jeng.serve_queue(_queue(cfg, lengths, 7, JRequest), extras=jextras)
    got = eng.serve_queue(_queue(cfg, lengths, 7, Request), extras=extras)
    assert [r.out for r in got] == [r.out for r in ref]
    assert all(r.done and len(r.out) == r.max_new for r in got)


def test_serve_events_match_the_reference():
    """The ``serve.queue`` and ``serve.batch`` spans carry the reference's
    fields: lanes, slots, each batch's size, queue depth and padded
    prompt length."""
    cfg, jeng, eng = _pair("llama3.2-3b", batch=2, max_len=64)
    lengths = [4, 30, 3, 16, 2]

    def fields(trace, keys_of):
        return ([{k: e[k] for k in ("service", "slots", "lanes")}
                 for e in trace.select("serve.queue")],
                [{k: e[k] for k in keys_of} for e in trace.select("serve.batch")])

    keys = ("service", "batch", "slots", "queued", "prompt_len")
    with jobs.capture() as jtrace:
        jeng.serve_queue(_queue(cfg, lengths, 8, JRequest))
    with obs.capture() as trace:
        eng.serve_queue(_queue(cfg, lengths, 8, Request))
    assert fields(trace, keys) == fields(jtrace, keys)
    assert len(trace.select("serve.batch")) == 4


def test_each_lane_batch_starts_from_empty_caches():
    """Two lane batches in one call, the longer prompts first: one engine
    gives the tokens two fresh engines give, and the reference's, and after
    the second (shorter) batch its caches hold that batch's positions and
    nothing of the first's. (In a dense cache a stale slot holds a later
    position than the decode has reached, so the mask hides it and the
    tokens alone cannot show a missing reset: the caches are read.)"""
    cfg, jeng, eng = _pair("llama3.2-3b", batch=2, max_len=64, seed=4)
    long = _queue(cfg, [14, 13], 9, Request)
    short = _queue(cfg, [6, 5], 10, Request)
    for r in long + short:
        r.max_new = 6
    eng.serve_queue(long + short)
    fresh = []
    for group in (long, short):
        _, _, alone = _pair("llama3.2-3b", batch=2, max_len=64, seed=4)
        fresh.append(alone.serve_queue([Request(prompt=r.prompt, max_new=6) for r in group]))
    assert [r.out for r in long] == [r.out for r in fresh[0]]
    assert [r.out for r in short] == [r.out for r in fresh[1]]
    jq = [JRequest(prompt=r.prompt, max_new=6) for r in long + short]
    jeng.serve_queue(jq)
    assert [r.out for r in long + short] == [r.out for r in jq]
    slot_pos = eng.caches["dense_layers"]["slot_pos"]
    assert int(slot_pos.max()) == 6 + 6 - 1  # the last batch's positions, no more
    for key in ("k", "v"):
        assert not bool(eng.caches["dense_layers"][key][:, :, 6 + 6:].any())


@pytest.mark.parametrize("arch", ["xlstm-350m", "zamba2-2.7b", "mixtral-8x22b",
                                  "deepseek-v3-671b"])
def test_each_lane_batch_starts_from_the_initial_state_caches(arch):
    """Every prefill, the first lane batch's too, finds every cache leaf as
    the model's ``init_cache_fn`` made it: xlstm's stabilisers ``m`` all at
    −inf, zamba2's, mixtral's ring and deepseek's MLA ``slot_pos`` −1,
    every other leaf (MLA's ``c_kv`` and ``k_rope``) 0. After each lane
    batch the states hold that batch's values (m finite), so the reset is
    what brings m back to −inf. Two lane batches in one call give the
    tokens two fresh engines give."""
    cfg, _, eng = _pair(arch, batch=2, max_len=64, seed=4)
    fresh = param_tree_leaves(eng.model.init_cache_fn(2, 64, torch.float32, "cpu"))
    seen = []
    run = eng.model.prefill_fn

    def prefill(params, batch, caches):
        leaves = param_tree_leaves(caches)
        seen.append([torch.equal(t, f) for t, f in zip(leaves, fresh)])
        if arch == "xlstm-350m":
            seen[-1].append([bool(torch.isneginf(caches[n]["m"]).all())
                             for n in ("mlstm", "slstm")])
        return run(params, batch, caches)

    eng.model = dataclasses.replace(eng.model, prefill_fn=prefill)
    long = _queue(cfg, [14, 13], 9, Request)
    short = _queue(cfg, [6, 5], 10, Request)
    eng.serve_queue(long + short)
    assert len(seen) == 2
    for leaves in seen:
        assert all(leaves[:len(fresh)])
        if arch == "xlstm-350m":
            assert leaves[-1] == [True, True]
    if arch == "xlstm-350m":  # the last batch's states are its own, m finite
        assert bool(torch.isfinite(eng.caches["mlstm"]["m"]).all())
        assert bool(torch.isfinite(eng.caches["slstm"]["m"]).all())
    for group in (long, short):
        _, _, alone = _pair(arch, batch=2, max_len=64, seed=4)
        again = alone.serve_queue([Request(prompt=r.prompt, max_new=r.max_new) for r in group])
        assert [r.out for r in group] == [r.out for r in again]


def test_xlstm_tokens_need_the_stabilisers_back_at_minus_inf():
    """The stabiliser m cancels out of the mLSTM's output and of the sLSTM's
    c / n, except where the sLSTM's floor n >= 1e-6 binds: with its input
    gates shut (bias −20 on the i block, the same weights in both
    packages), the first step gives n = 1 from m = −inf but n = e^−19 from
    m = 0, and the tokens part. So the reference's tokens come back only if
    every lane batch, the first too, starts m at −inf."""
    cfg, jeng, eng = _pair("xlstm-350m", batch=3, max_len=64)
    d = cfg.d_model
    jeng.params["slstm_layers"]["bias"] = jeng.params["slstm_layers"]["bias"].at[:, :d].set(-20.0)
    eng.params["slstm_layers"]["bias"][:, :d] = -20.0
    lengths = [3, 5, 8, 12, 17, 30, 6, 9]
    ref = jeng.serve_queue(_queue(cfg, lengths, 7, JRequest))
    got = eng.serve_queue(_queue(cfg, lengths, 7, Request))
    assert [r.out for r in got] == [r.out for r in ref]


def test_engine_refuses_an_initial_cache_it_could_not_restore(engine):
    """The engine records one value a cache leaf, the value every element
    held when ``init_cache_fn`` made it; a leaf that holds several is
    refused when the engine is built, not reset wrongly later."""
    cfg, model, params, _ = engine

    def init_cache(b, s, dtype=torch.float32, device=None):
        caches = model.init_cache_fn(b, s, dtype, device)
        caches["dense_layers"]["slot_pos"] = torch.arange(s, dtype=torch.int32)
        return caches

    with pytest.raises(ValueError, match="one value throughout"):
        ServeEngine(dataclasses.replace(model, init_cache_fn=init_cache), params, batch=2,
                    max_len=64)


def test_tensor_prompts_serve_as_numpy_prompts(engine):
    cfg, model, params, eng = engine
    queue = _queue(cfg, [6, 7, 12], 11, Request)
    as_tensors = [Request(prompt=torch.from_numpy(r.prompt), max_new=r.max_new) for r in queue]
    eng.serve_queue(queue)
    eng.serve_queue(as_tensors)
    assert [r.out for r in as_tensors] == [r.out for r in queue]


def test_queue_over_max_queue_is_shed_before_any_lane():
    cfg, jeng, eng = _pair("llama3.2-3b", batch=2, max_len=64, policy={"max_queue": 2})
    with pytest.raises(JOverloaded):
        jeng.serve_queue(_queue(cfg, [4, 4, 4], 12, JRequest))
    queue = _queue(cfg, [4, 4, 4], 12, Request)
    with obs.capture() as trace:
        with pytest.raises(Overloaded):
            eng.serve_queue(queue)
    assert not trace.select("serve.batch") and not any(r.done for r in queue)


def test_generate_takes_one_prompt_a_slot(engine):
    cfg, model, params, eng = engine
    with pytest.raises(ValueError, match="takes 2 prompts"):
        eng.generate([np.zeros(4, np.int32)])


# ------------------------------ the launcher ------------------------------


@pytest.mark.parametrize("arch", ["llama3.2-3b", "internvl2-76b", "xlstm-350m", "zamba2-2.7b",
                                  "mixtral-8x22b", "deepseek-v3-671b"])
def test_launcher_serves_smoke_config_on_the_cpu(arch, capsys):
    done = launch_serve.main(["--arch", arch, "--smoke", "--device", "cpu", "--requests", "3",
                              "--batch", "2", "--max-new", "4"])
    cfg = reg.smoke_config(arch)
    assert len(done) == 3 and all(r.done and len(r.out) == 4 for r in done)
    assert all(0 <= t < cfg.vocab for r in done for t in r.out)
    out = capsys.readouterr().out
    assert f"[serve] 3 requests, 12 tokens" in out and f"arch={cfg.name} device=cpu" in out

