"""The training substrate: the port's ``data``, ``train.compression``,
``train.checkpoint``, ``train.trainer`` and ``launch.train`` against the
JAX package's.

- ``synthetic_lm_batches``: tokens and labels ``np.array_equal`` to the
  reference's, from any ``start_step``.
- ``compress``: equal int8 ``q`` and equal float32 ``scale`` and ``err``
  (the same float32 operations; both round half to even).
- The reference's checkpoint tests (round trip, keep-last-n, shape
  mismatch, a partial write) on the port; then a checkpoint of a
  training state written by the reference restored by the port, and the
  reverse: equal arrays, equal manifests.
- The reference's restart drill on the port: a run that fails at step 7
  and resumes from its step-5 checkpoint ends bit-identical to an
  uninterrupted run.
- ``launch.train.main([..., "--device", "cpu", "--smoke"])``.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.data import synthetic_lm_batches
from repro_torch.launch import train as launch_train
from repro_torch.models import transformer as tf
from repro_torch.optim import AdamW, AdamWState
from repro_torch.train import Trainer, TrainerConfig, checkpoint, compression

from test_torch_reference import load_reference

ref_configs = load_reference("configs")
ref_tf = load_reference("models.transformer")
ref_optim = load_reference("optim")
ref_ckpt = load_reference("train.checkpoint")
ref_comp = load_reference("train.compression")
ref_tokens = load_reference("data.tokens")


# ----------------------------------------------------------------- data
@pytest.mark.parametrize("seed,start", [(0, 0), (9, 3), (3, 5)])
def test_synthetic_batches_equal_the_reference(seed, start):
    ours = synthetic_lm_batches(100, 2, 8, seed=seed, start_step=start,
                                device="cpu")
    ref = ref_tokens.synthetic_lm_batches(100, 2, 8, seed=seed,
                                          start_step=start)
    for _ in range(4):
        a, b = next(ours), next(ref)
        for key in ("tokens", "labels"):
            assert a[key].dtype == torch.int32
            assert np.array_equal(a[key].numpy(), np.asarray(b[key])), key


def test_data_determinism_and_seek():
    """The reference's ``test_data_determinism_and_seek`` on the port."""
    it1 = synthetic_lm_batches(100, 2, 8, seed=9, device="cpu")
    batches = [next(it1) for _ in range(5)]
    b3 = next(synthetic_lm_batches(100, 2, 8, seed=9, start_step=3,
                                   device="cpu"))
    assert torch.equal(batches[3]["tokens"], b3["tokens"])
    labels, tokens = batches[0]["labels"], batches[0]["tokens"]
    assert bool((labels[:, :-1] == tokens[:, 1:]).all())


# ---------------------------------------------------------- compression
def test_compress_equals_the_reference():
    rng = np.random.default_rng(0)
    for scale in (1.0, 1e-3, 37.0):
        x = (rng.standard_normal((64, 33)) * scale).astype(np.float32)
        ef = (rng.standard_normal((64, 33)) * scale * 0.01).astype(np.float32)
        q, s, err = compression.compress(torch.from_numpy(x),
                                         torch.from_numpy(ef))
        rq, rs, rerr = ref_comp.compress(jnp.asarray(x), jnp.asarray(ef))
        assert q.dtype == torch.int8
        assert np.array_equal(q.numpy(), np.asarray(rq))
        assert np.array_equal(s.numpy(), np.asarray(rs))
        assert np.array_equal(err.numpy(), np.asarray(rerr))
        assert np.array_equal(compression.decompress(q, s).numpy(),
                              np.asarray(ref_comp.decompress(rq, rs)))


def test_compress_rounds_half_to_even():
    x = torch.tensor([0.5, 1.5, 2.5, -0.5, -2.5, 127.0])
    q, scale, _ = compression.compress(x, torch.zeros_like(x))
    assert float(scale) == pytest.approx(1.0)
    rq, _, _ = ref_comp.compress(jnp.asarray(x.numpy()), jnp.zeros(6))
    assert q.tolist() == np.asarray(rq).tolist() == [0, 2, 2, 0, -2, 127]


def test_compression_roundtrip_and_error_feedback():
    """The reference's compression tests on the port."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal(1000).astype(np.float32))
    q, scale, _ = compression.compress(x, torch.zeros_like(x))
    x_hat = compression.decompress(q, scale)
    assert float((x - x_hat).abs().max()) <= float(scale) * 0.5 + 1e-6
    g_true = torch.from_numpy(np.random.default_rng(1).standard_normal(
        256).astype(np.float32))
    ef, acc = torch.zeros_like(g_true), torch.zeros_like(g_true)
    for _ in range(200):
        q, s, ef = compression.compress(g_true, ef)
        acc = acc + compression.decompress(q, s)
    np.testing.assert_allclose((acc / 200).numpy(), g_true.numpy(),
                               atol=5e-3)
    grads = {"w": torch.ones(4, 4), "b": torch.full((4,), -2.0)}
    out, new_ef = compression.compressed_gradients(
        grads, compression.init_ef_state(grads))
    assert set(out) == set(new_ef) == {"w", "b"}
    np.testing.assert_allclose(out["w"].numpy(), 1.0, atol=1e-2)
    qs, scales, errs = compression.compress_tree(
        grads, compression.init_ef_state(grads))
    assert {q.dtype for q in qs.values()} == {torch.int8}
    for n, d in compression.decompress_tree(qs, scales).items():
        assert torch.equal(d, out[n])


# ----------------------------------------------------------- checkpoint
class TestCheckpoint:
    """The reference's ``TestCheckpoint`` on the port."""

    def test_roundtrip(self, tmp_path):
        tree = {"a": torch.arange(6.0).reshape(2, 3),
                "b": {"c": torch.tensor([1, 2], dtype=torch.int32)}}
        checkpoint.save(str(tmp_path), 7, tree)
        restored, step = checkpoint.restore(str(tmp_path), tree)
        assert step == 7
        assert torch.equal(restored["a"], tree["a"])
        assert torch.equal(restored["b"]["c"], tree["b"]["c"])
        assert restored["b"]["c"].dtype == torch.int32

    def test_keep_last_n(self, tmp_path):
        tree = {"x": torch.zeros(3)}
        for s in range(6):
            checkpoint.save(str(tmp_path), s, tree, keep=2)
        assert checkpoint.all_steps(str(tmp_path)) == [4, 5]
        assert checkpoint.latest_step(str(tmp_path)) == 5

    def test_shape_mismatch_raises(self, tmp_path):
        checkpoint.save(str(tmp_path), 0, {"x": torch.zeros((2, 2))})
        with pytest.raises(ValueError):
            checkpoint.restore(str(tmp_path), {"x": torch.zeros((3,))})

    def test_partial_write_never_corrupts(self, tmp_path):
        tree = {"x": torch.ones(4)}
        checkpoint.save(str(tmp_path), 1, tree)
        open(os.path.join(tmp_path, ".tmp-99.npz"), "wb").write(b"junk")
        restored, step = checkpoint.restore(str(tmp_path), tree)
        assert step == 1

    def test_no_checkpoint_raises(self, tmp_path):
        with pytest.raises(FileNotFoundError):
            checkpoint.restore(str(tmp_path / "none"), {"x": torch.ones(1)})


def _state_pair(arch, seed=0, steps=2):
    """A training state in both packages on the same numbers: the
    reference's parameters (bfloat16, the router float32) after
    ``steps`` AdamW steps on its own, and the port's (LM, AdamWState)
    holding the same values."""
    cfg = configs.get(arch).scaled(n_layers=2)
    ref_cfg = ref_configs.get(arch).scaled(n_layers=2)
    params = ref_tf.init_lm(ref_cfg, jax.random.key(seed))
    opt = ref_optim.AdamW(lr=1e-3)
    state = opt.init(params)
    step = jax.jit(ref_tf.make_train_step(ref_cfg, opt))
    toks = np.random.default_rng(seed).integers(0, cfg.vocab, (2, 16),
                                                dtype=np.int32)
    for _ in range(steps):
        params, state, _ = step(params, state,
                                {"tokens": toks, "labels": toks})
    model = tf.params_from_numpy(cfg, jax.tree.map(np.asarray, params),
                                 device="cpu")
    names = [n for n, _ in model.named_parameters()]

    def moments(tree):
        return _named_moments(cfg, tree, names)

    port = (model, AdamWState(torch.tensor(int(state.step),
                                           dtype=torch.int32),
                              moments(state.mu), moments(state.nu)))
    return cfg, (params, state), port


def _named_moments(cfg, tree, names):
    """A reference moment tree as the port's dict keyed by parameter
    name (float32, per-layer rows)."""
    out = {}
    for n in names:
        parts = n.split(".")
        a = (np.asarray(tree["layers"][parts[2]])[int(parts[1])]
             if parts[0] == "layers" else np.asarray(tree[n]))
        out[n] = torch.from_numpy(np.array(a, np.float32))
    return out


def _files(path, step):
    z = np.load(os.path.join(path, f"step-{step:08d}.npz"))
    with open(os.path.join(path, f"step-{step:08d}.json")) as f:
        return {k: z[k] for k in z.files}, json.load(f)


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "mixtral-8x7b"])
def test_checkpoints_cross_between_packages(arch, tmp_path):
    cfg, ref_state, port_state = _state_pair(arch)
    ref_ckpt.save(str(tmp_path / "ref"), 2, ref_state)
    checkpoint.save(str(tmp_path / "port"), 2, port_state)
    ref_arrays, ref_manifest = _files(tmp_path / "ref", 2)
    arrays, manifest = _files(tmp_path / "port", 2)
    assert manifest == ref_manifest
    assert manifest["keys"][:3] == ["0/embed", "0/final_norm",
                                    "0/layers/attn_norm"]
    assert arrays.keys() == ref_arrays.keys()
    for k in arrays:
        assert arrays[k].dtype == ref_arrays[k].dtype, k
        assert np.array_equal(arrays[k], ref_arrays[k]), k

    # the reference's files restored by the port, into the port's forms
    (model, opt_state), step = checkpoint.restore(str(tmp_path / "ref"),
                                                  port_state)
    assert step == 2 and isinstance(model, tf.LM)
    assert isinstance(opt_state, AdamWState)
    for (n, p), (_, want) in zip(model.named_parameters(),
                                 port_state[0].named_parameters()):
        assert p.dtype == want.dtype and torch.equal(p, want), n
        assert not p.requires_grad
    assert opt_state.step.dtype == torch.int32 and int(opt_state.step) == 2
    for n, m in opt_state.mu.items():
        assert torch.equal(m, port_state[1].mu[n]), n
        assert torch.equal(opt_state.nu[n], port_state[1].nu[n]), n

    # the port's files restored by the reference
    (params, state), step = ref_ckpt.restore(str(tmp_path / "port"),
                                             ref_state)
    for a, b in zip(jax.tree.leaves((params, state)),
                    jax.tree.leaves(ref_state)):
        assert a.dtype == b.dtype
        assert np.array_equal(np.asarray(a.astype(jnp.float32)),
                              np.asarray(b.astype(jnp.float32)))


def test_compressed_state_keeps_the_reference_shape(tmp_path):
    """``build_step_and_state(compress_grads=True)``'s state is the
    reference's ``(params, ((params, opt), ef))`` on disk."""
    cfg = configs.get("tinyllama-1.1b").scaled(n_layers=1, d_model=32,
                                               n_heads=2, d_ff=64, vocab=64)
    ref_cfg = ref_configs.get("tinyllama-1.1b").scaled(
        n_layers=1, d_model=32, n_heads=2, d_ff=64, vocab=64)
    step, state = launch_train.build_step_and_state(
        cfg, compress_grads=True, device="cpu")
    batch = next(synthetic_lm_batches(cfg.vocab, 2, 8, device="cpu"))
    model, state2, m = step(state[0], state[1], batch)
    assert set(m) == {"loss", "gnorm"} and np.isfinite(float(m["loss"]))
    checkpoint.save(str(tmp_path / "port"), 1, (model, state2))
    params = ref_tf.init_lm(ref_cfg, jax.random.key(0))
    opt = ref_optim.AdamW()
    ef = ref_comp.init_ef_state(params)
    ref_ckpt.save(str(tmp_path / "ref"), 1,
                  (params, ((params, opt.init(params)), ef)))
    _, manifest = _files(tmp_path / "port", 1)
    _, ref_manifest = _files(tmp_path / "ref", 1)
    assert manifest == ref_manifest
    restored, _ = checkpoint.restore(str(tmp_path / "port"), state)
    assert torch.equal(restored[1][1]["embed"], state2[1]["embed"])


# -------------------------------------------------------------- trainer
def _tiny_setup(path, total_steps=12, ckpt_every=4, fail_at=None):
    """The reference's ``_tiny_setup`` on the port (bfloat16 parameters
    from a seeded generator)."""
    cfg = configs.get("tinyllama-1.1b").scaled(n_layers=1, d_model=32,
                                               n_heads=2, d_ff=64, vocab=64)
    model = tf.init_lm(cfg, generator=torch.Generator().manual_seed(0),
                       device="cpu")
    opt = AdamW(lr=1e-3)
    state = (model, opt.init(model))
    step = tf.make_train_step(cfg, opt)
    data = synthetic_lm_batches(cfg.vocab, 2, 16, seed=3, device="cpu")
    failed = {"done": False}

    def failure_hook(s):
        if fail_at is not None and s == fail_at and not failed["done"]:
            failed["done"] = True
            raise RuntimeError("injected node failure")

    return Trainer(TrainerConfig(total_steps=total_steps,
                                 checkpoint_every=ckpt_every,
                                 ckpt_dir=str(path), log_every=1000),
                   step, state, data,
                   failure_hook=failure_hook if fail_at else None,
                   log_fn=lambda *a: None)


class TestTrainerFaultTolerance:
    """The reference's ``TestTrainerFaultTolerance`` on the port."""

    def test_failure_restart_bit_identical(self, tmp_path):
        tr_a = _tiny_setup(tmp_path / "a", total_steps=10, ckpt_every=5)
        out_a = tr_a.run()
        assert out_a["final_step"] == 10
        tr_b = _tiny_setup(tmp_path / "b", total_steps=10, ckpt_every=5,
                           fail_at=7)
        with pytest.raises(RuntimeError):
            tr_b.run()
        tr_c = _tiny_setup(tmp_path / "b", total_steps=10, ckpt_every=5)
        assert tr_c.try_resume()
        assert tr_c.step == 5
        tr_c.data = synthetic_lm_batches(64, 2, 16, seed=3, start_step=5,
                                         device="cpu")
        tr_c.run()
        for (n, a), (_, b) in zip(tr_a.state[0].named_parameters(),
                                  tr_c.state[0].named_parameters()):
            assert torch.equal(a, b), n
        for n in tr_a.state[1].mu:
            assert torch.equal(tr_a.state[1].mu[n], tr_c.state[1].mu[n]), n
            assert torch.equal(tr_a.state[1].nu[n], tr_c.state[1].nu[n]), n
        hist_a = [m["loss"] for m in out_a["history"]]
        assert [m["loss"] for m in tr_c.metrics_history] == hist_a[5:]

    def test_resume_without_checkpoint_is_false(self, tmp_path):
        assert not _tiny_setup(tmp_path / "c").try_resume()

    def test_metrics_are_host_floats(self, tmp_path):
        tr = _tiny_setup(tmp_path / "d", total_steps=2, ckpt_every=5)
        out = tr.run()
        assert set(out["history"][0]) == {"loss", "nll", "aux", "gnorm",
                                          "step_time_s"}
        assert all(isinstance(v, float) for v in out["history"][0].values())
        assert checkpoint.all_steps(str(tmp_path / "d")) == [2]


# ------------------------------------------------------------- launcher
def test_launch_main_smoke(tmp_path, capsys):
    args = ["--smoke", "--steps", "4", "--checkpoint-every", "2",
            "--ckpt-dir", str(tmp_path), "--seq-len", "16",
            "--global-batch", "4", "--microbatches", "2", "--device", "cpu"]
    assert launch_train.main(args) == 0
    out = capsys.readouterr().out
    assert "done: step=4" in out
    assert checkpoint.all_steps(str(tmp_path)) == [2, 4]
    # resume from step 4 and run to 6, the data sought to step 4
    args[args.index("--steps") + 1] = "6"
    assert launch_train.main(args + ["--resume"]) == 0
    assert "done: step=6" in capsys.readouterr().out
    assert checkpoint.all_steps(str(tmp_path)) == [2, 4, 6]


def test_launch_main_compressed_and_mesh(tmp_path, capsys):
    assert launch_train.main(["--smoke", "--steps", "2", "--compress-grads",
                              "--ckpt-dir", str(tmp_path), "--seq-len", "8",
                              "--global-batch", "2", "--device", "cpu"]) == 0
    assert "done: step=2" in capsys.readouterr().out
    with pytest.raises(NotImplementedError, match="A11.5"):
        launch_train.main(["--production-mesh", "--device", "cpu"])


def test_launch_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        launch_train.build_step_and_state(configs.get("tinyllama-1.1b")
                                          .scaled())
