"""LM serving: the port's ``ServeEngine`` against the JAX package's on the
same model parameters and the same requests. Greedy decoding must give
the same tokens, the same requests must be rejected with the same error
text, and slots must free and refill in the same order.

Float32 parameters (the cache is bfloat16 on both sides): the logits
agree within 1e-3 (tests/test_torch_lm.py), far inside the top-2 margins
of these runs, so greedy tokens can be compared exactly.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.models import transformer as tf
from repro_torch.serve import Request, ServeEngine

from test_torch_reference import load_reference

ref_configs = load_reference("configs")
ref_tf = load_reference("models.transformer")
ref_engine = load_reference("serve.engine")


@pytest.fixture(scope="module")
def models():
    cfg = configs.get("tinyllama-1.1b").scaled()
    ref_cfg = ref_configs.get("tinyllama-1.1b").scaled()
    params = jax.tree.map(lambda a: a.astype(jnp.float32),
                          ref_tf.init_lm(ref_cfg, jax.random.key(0)))
    model = tf.params_from_numpy(
        cfg, jax.tree.map(np.asarray, params), device="cpu")
    return cfg, ref_cfg, params, model


def _requests(cls, seed, vocab):
    """Ten requests of mixed prompt lengths and budgets (one with an
    empty prompt), and two that can never fit ``max_len`` 40."""
    rng = np.random.default_rng(seed)
    reqs = []
    for uid in range(10):
        n = 0 if uid == 4 else int(rng.integers(3, 14))
        reqs.append(cls(uid=uid, prompt=rng.integers(1, vocab, n).tolist(),
                        max_new_tokens=int(rng.integers(4, 12))))
    reqs.insert(3, cls(uid=100, prompt=[1] * 35, max_new_tokens=6))
    reqs.append(cls(uid=101, prompt=[2] * 41, max_new_tokens=1))
    return reqs


def _drain(models, *, eos_id=-1, seed=0):
    cfg, ref_cfg, params, model = models
    ref = ref_engine.ServeEngine(ref_cfg, params, batch_slots=4, max_len=40,
                                 eos_id=eos_id)
    port = ServeEngine(cfg, model, batch_slots=4, max_len=40, eos_id=eos_id)
    assert port.device.type == "cpu"
    ref_reqs = ref.run_until_drained(_requests(ref_engine.Request, seed,
                                               cfg.vocab))
    port_reqs = port.run_until_drained(_requests(Request, seed, cfg.vocab))
    return ref, port, ref_reqs, port_reqs


@pytest.mark.parametrize("seed", [0, 1])
def test_generated_tokens_and_errors_match_reference(models, seed):
    ref, port, ref_reqs, port_reqs = _drain(models, seed=seed)
    assert [dataclasses.asdict(r) for r in port_reqs] == [
        dataclasses.asdict(r) for r in ref_reqs]
    rejected = [r for r in port_reqs if r.error]
    assert [r.uid for r in rejected] == [100, 101]
    assert rejected[0].error == "prompt (35) + max_new_tokens (6) exceed " \
                                "max_len=40"
    assert all(r.done for r in port_reqs)
    np.testing.assert_array_equal(port.t, ref.t)
    # one decode_step per step: prompt tokens plus generated tokens of
    # the longest-running slot chain
    assert port.steps >= max(len(r.prompt) + len(r.generated)
                             for r in port_reqs if not r.error)


def test_eos_frees_slots_as_the_reference(models):
    # an EOS id that the first drain generates mid-sequence
    _, _, first, _ = _drain(models)
    eos = first[0].generated[2]
    ref, port, ref_reqs, port_reqs = _drain(models, eos_id=eos)
    assert [r.generated for r in port_reqs] == [r.generated
                                               for r in ref_reqs]
    assert port_reqs[0].generated[-1] == eos
    assert len(port_reqs[0].generated) <= 3


def test_greedy_continuation_matches_full_forward(models):
    """As examples/serve_lm.py checks the reference: slot 0's greedy
    tokens equal greedy decoding by full forwards over the sequence."""
    cfg, _, _, model = models
    eng = ServeEngine(cfg, model, batch_slots=4, max_len=96)
    rng = np.random.default_rng(0)
    reqs = [Request(uid=i, prompt=rng.integers(1, cfg.vocab, 8).tolist(),
                    max_new_tokens=12) for i in range(10)]
    eng.run_until_drained(reqs)
    toks = list(reqs[0].prompt)
    for _ in range(3):
        logits, _ = tf.forward(model, torch.tensor([toks]),
                               attn_path="dense")
        toks.append(int(logits[0, -1].argmax()))
    assert toks[len(reqs[0].prompt):] == reqs[0].generated[:3]


@pytest.mark.parametrize("seed", [0, 1])
def test_moe_swa_serving_matches_reference(seed):
    """A MoE model under a window of 8 slots, smaller than ``max_len``:
    prompts of 9-20 tokens, so every slot's decode ring wraps while it
    feeds and generates; the same tokens as the reference's engine."""
    cfg = configs.get("mixtral-8x7b").scaled(window=8)
    ref_cfg = ref_configs.get("mixtral-8x7b").scaled(window=8)
    params = jax.tree.map(lambda a: a.astype(jnp.float32),
                          ref_tf.init_lm(ref_cfg, jax.random.key(seed)))
    model = tf.params_from_numpy(cfg, jax.tree.map(np.asarray, params),
                                 device="cpu")

    def requests(cls):
        rng = np.random.default_rng(seed)
        return [cls(uid=uid, prompt=rng.integers(
            1, cfg.vocab, int(rng.integers(9, 21))).tolist(),
            max_new_tokens=int(rng.integers(4, 12))) for uid in range(8)]

    ref = ref_engine.ServeEngine(ref_cfg, params, batch_slots=4, max_len=40)
    port = ServeEngine(cfg, model, batch_slots=4, max_len=40)
    assert port.cache["k"].shape[2] == 8 < port.max_len
    ref_reqs = ref.run_until_drained(requests(ref_engine.Request))
    port_reqs = port.run_until_drained(requests(Request))
    assert [dataclasses.asdict(r) for r in port_reqs] == [
        dataclasses.asdict(r) for r in ref_reqs]
    assert all(r.done and r.error is None for r in port_reqs)
    np.testing.assert_array_equal(port.t, ref.t)
    assert max(len(r.prompt) + len(r.generated) for r in port_reqs) > 8
