"""The port's serving side (``repro_torch.serving``) against the
reference's (``repro.serving``): greedy generation, the continuous
batcher, the RAG pipeline (static and streaming stores), and sampling.

Weights are the reference's, handed over with ``params_from_jax``;
datasets and prompts are numpy draws from a seed given to both packages.
Cross-package comparisons run the models in ``float32``: greedy tokens
are then required to be equal (the logits agree to ~1e-6, far inside the
top-2 gaps of these random models), as are retrieved document ids.  The
port's own batcher-vs-``generate`` check also runs in the reference
test's ``bfloat16``.  Sampling cannot reproduce ``jax.random``'s bits:
those tests hold the support (top-k) and reproducibility under a seed.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core import CubeGraphConfig as JaxCubeGraphConfig
from repro.core.workloads import make_box_filter as jax_make_box_filter
from repro.core.workloads import make_dataset
from repro.models import build_model as jax_build_model
from repro.models import init_params as jax_init_params
from repro.serving.batching import ContinuousBatcher as JaxBatcher
from repro.serving.batching import Request as JaxRequest
from repro.serving.rag import Document as JaxDocument
from repro.serving.rag import DocumentStore as JaxDocumentStore
from repro.serving.rag import RAGPipeline as JaxRAGPipeline
from repro.serving.serve_step import generate as jax_generate
from repro.streaming import StreamConfig as JaxStreamConfig
from repro_torch.configs import get_config
from repro_torch.core import BoxFilter, CubeGraphConfig
from repro_torch.core.workloads import make_box_filter
from repro_torch.models import build_model, init_params, params_from_jax
from repro_torch.serving import (ContinuousBatcher, Document, DocumentStore,
                                 RAGPipeline, Request, generate,
                                 sample_logits)
from repro_torch.streaming import StreamConfig

torch.set_num_threads(1)


def _models(arch, **over):
    jcfg = dataclasses.replace(jax_get_config(arch, smoke=True), **over)
    cfg = dataclasses.replace(get_config(arch, smoke=True), **over)
    jm = jax_build_model(jcfg)
    jp = jax_init_params(jm.param_specs(), jax.random.key(0))
    pm = build_model(cfg)
    pp = params_from_jax(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    return cfg, jm, jp, pm, pp


@pytest.fixture(scope="module")
def dense32():
    return _models("codeqwen1.5-7b", dtype="float32")


@pytest.fixture(scope="module")
def dense_bf16():
    cfg = get_config("codeqwen1.5-7b", smoke=True)
    model = build_model(cfg)
    return cfg, model, init_params(model.param_specs(), seed=0,
                                   device="cpu")


def test_greedy_generate_matches_reference(dense32):
    cfg, jm, jp, pm, pp = dense32
    prompt = np.random.default_rng(1).integers(0, cfg.vocab, size=(2, 6))
    want = np.asarray(jax_generate(jm, jp, jnp.asarray(prompt, jnp.int32),
                                   max_new=6, max_len=16))
    got = generate(pm, pp, prompt.astype(np.int32), max_new=6, max_len=16)
    assert got.dtype == torch.int32 and got.shape == (2, 6)
    np.testing.assert_array_equal(got.numpy(), want)


def test_prefill_matches_stepwise_decode(dense32):
    """Greedy decode after prefill(prompt) == argmax of the forward over
    prompt + generated (the reference's own check, on the port)."""
    cfg, _, _, pm, pp = dense32
    prompt = np.random.default_rng(1).integers(0, cfg.vocab, size=(2, 6))
    out = generate(pm, pp, prompt, max_new=4, max_len=16)
    full = torch.cat([torch.as_tensor(prompt), out[:, :-1].long()], dim=1)
    logits, _ = pm.logits(pp, full)
    pred = torch.argmax(logits[:, 5:, :].float(), dim=-1)
    np.testing.assert_array_equal(pred.numpy(), out.numpy())


def test_generate_refuses_a_cache_too_small(dense32):
    cfg, _, _, pm, pp = dense32
    with pytest.raises(ValueError, match="do not fit"):
        generate(pm, pp, np.ones((1, 6), np.int32), max_new=8, max_len=10)


def _batcher_prompts(cfg):
    rng = np.random.default_rng(2)
    return [rng.integers(2, cfg.vocab, size=(n,)).astype(np.int32)
            for n in (3, 5, 4, 6, 3)]


def _drain(batcher_cls, request_cls, model, params, prompts):
    batcher = batcher_cls(model, params, n_slots=2, max_len=32, eos_id=-1)
    for i, p in enumerate(prompts):
        batcher.submit(request_cls(req_id=i, prompt=p, max_new=5))
    done = batcher.run_until_drained()
    assert len(done) == len(prompts)
    return {r.req_id: np.asarray(r.output) for r in done}, batcher


def test_continuous_batcher_matches_generate_and_reference(dense32):
    """The setting of ``tests/test_serving.py``'s batcher test: five
    prompts through two slots equal standalone generation and the
    reference batcher's outputs."""
    cfg, jm, jp, pm, pp = dense32
    prompts = _batcher_prompts(cfg)
    got, batcher = _drain(ContinuousBatcher, Request, pm, pp, prompts)
    theirs, jb = _drain(JaxBatcher, JaxRequest, jm, jp, prompts)
    assert batcher.steps == jb.steps
    for i, p in enumerate(prompts):
        alone = generate(pm, pp, p[None, :], max_new=5, max_len=32)[0]
        np.testing.assert_array_equal(got[i], alone.numpy())
        np.testing.assert_array_equal(got[i], theirs[i])


def test_continuous_batcher_matches_generate_bf16(dense_bf16):
    cfg, model, params = dense_bf16
    prompts = _batcher_prompts(cfg)
    got, _ = _drain(ContinuousBatcher, Request, model, params, prompts)
    for i, p in enumerate(prompts):
        alone = generate(model, params, p[None, :], max_new=5, max_len=32)
        np.testing.assert_array_equal(got[i], alone[0].numpy())


def test_batcher_frees_slots(dense_bf16):
    cfg, model, params = dense_bf16
    batcher = ContinuousBatcher(model, params, n_slots=2, max_len=32,
                                eos_id=-1)
    for i in range(4):
        batcher.submit(Request(req_id=i, prompt=np.ones(3, np.int32),
                               max_new=3))
    done = batcher.run_until_drained()
    assert len(done) == 4                  # 4 requests through 2 slots
    assert all(len(r.output) == 3 for r in done)


def test_batcher_ends_a_slot_before_the_cache_is_full(dense_bf16):
    """A request whose budget outlasts the cache ends at pos max_len - 1
    (the reference's rule); the batcher never decodes at pos >= max_len."""
    cfg, model, params = dense_bf16
    batcher = ContinuousBatcher(model, params, n_slots=1, max_len=12,
                                eos_id=-1)
    batcher.submit(Request(req_id=0, prompt=np.ones(5, np.int32),
                           max_new=50))
    done = batcher.run_until_drained()
    assert len(done[0].output) == 12 - 5
    with pytest.raises(ValueError, match="does not fit"):
        batcher.submit(Request(req_id=1, prompt=np.ones(12, np.int32),
                               max_new=2))
        batcher.step()


# ---------------------------------------------------------------------------
# RAG (the fixture of tests/test_rag.py, in float32)
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def rag():
    x, s = make_dataset(1200, 24, 3, seed=1)     # 2D geo + time
    x, s = np.asarray(x), np.asarray(s)
    rng = np.random.default_rng(2)
    toks = [rng.integers(2, 250, size=12).astype(np.int32)
            for _ in range(1200)]
    jdocs = [JaxDocument(i, toks[i], x[i], s[i]) for i in range(1200)]
    docs = [Document(i, toks[i], x[i], s[i]) for i in range(1200)]
    icfg = dict(n_layers=3, m_intra=10, m_cross=3)
    jstore = JaxDocumentStore(jdocs, JaxCubeGraphConfig(**icfg))
    store = DocumentStore(docs, CubeGraphConfig(**icfg), device="cpu")
    cfg, jm, jp, pm, pp = _models("internvl2-2b", n_patches=0,
                                  dtype="float32")
    return dict(x=x, s=s, jstore=jstore, store=store, cfg=cfg, jm=jm, jp=jp,
                pm=pm, pp=pp)


def test_retrieval_respects_filter_and_matches_reference(rag):
    f = make_box_filter(3, 0.1, seed=3)
    jf = jax_make_box_filter(3, 0.1, seed=3)
    got = rag["store"].retrieve(rag["x"][7], f, k=5, ef=64)[0]
    want = rag["jstore"].retrieve(rag["x"][7], jf, k=5, ef=64)[0]
    assert [d.doc_id for d in got] == [d.doc_id for d in want]
    assert not got.degraded
    for d in got:
        assert bool(f.contains(torch.as_tensor(d.metadata[None, :]))[0])


def test_rag_answer_matches_reference(rag):
    pipe = RAGPipeline(rag["store"], rag["pm"], rag["pp"], max_context=64)
    jpipe = JaxRAGPipeline(rag["jstore"], rag["jm"], rag["jp"],
                           max_context=64)
    rng = np.random.default_rng(5)
    query = rng.integers(2, 250, size=6).astype(np.int32)
    np.testing.assert_array_equal(pipe.embed_query(query),
                                  jpipe.embed_query(query))
    out, docs = pipe.answer(query, make_box_filter(3, 0.2, seed=4), k=3,
                            max_new=8)
    jout, jdocs = jpipe.answer(query, jax_make_box_filter(3, 0.2, seed=4),
                               k=3, max_new=8)
    assert [d.doc_id for d in docs] == [d.doc_id for d in jdocs]
    assert 1 <= len(docs) <= 3
    assert len(out) == 8 and all(0 <= t < rag["cfg"].vocab for t in out)
    np.testing.assert_array_equal(out, np.asarray(jout))


def test_rag_store_insert(rag):
    """New documents become retrievable (paper §4.4)."""
    store = DocumentStore(rag["store"].docs[:300],
                          CubeGraphConfig(n_layers=3, m_intra=10, m_cross=3),
                          device="cpu")
    rng = np.random.default_rng(6)
    new = [Document(300 + i, rng.integers(2, 250, size=12).astype(np.int32),
                    rag["x"][i] + 0.01, np.asarray([0.5, 0.5, 0.5]))
           for i in range(8)]
    store.insert(new)
    assert store.index.n == 308
    f = BoxFilter(lo=np.asarray([0.45, 0.45, 0.45]),
                  hi=np.asarray([0.55, 0.55, 0.55]))
    got = store.retrieve(rag["x"][0] + 0.01, f, k=4, ef=64)[0]
    assert any(d.doc_id >= 300 for d in got)


def test_streaming_store_matches_reference(rag):
    """A streaming store (segments sealed every 256 points) retrieves the
    reference streaming store's documents."""
    n = 1000
    x, s = rag["x"][:n], rag["s"][:n].copy()
    s[:, 2] = np.arange(n) / n                       # time-ordered ingest
    toks = [d.tokens for d in rag["store"].docs[:n]]
    kw = dict(time_dim=2, seal_max_points=256)
    icfg = dict(n_layers=3, m_intra=10, m_cross=3)
    jstore = JaxDocumentStore(
        [JaxDocument(i, toks[i], x[i], s[i]) for i in range(n)],
        streaming=True, stream_cfg=JaxStreamConfig(
            index_cfg=JaxCubeGraphConfig(**icfg), **kw))
    store = DocumentStore(
        [Document(i, toks[i], x[i], s[i]) for i in range(n)],
        streaming=True, stream_cfg=StreamConfig(
            index_cfg=CubeGraphConfig(**icfg), **kw), device="cpu")
    for store_ in (store, jstore):
        store_.maintenance()
    f = make_box_filter(3, 0.3, seed=8)
    jf = jax_make_box_filter(3, 0.3, seed=8)
    q = x[[3, 500, 900]] + 0.01
    got = store.retrieve(q, f, k=5)
    want = jstore.retrieve(q, jf, k=5)
    for g, w in zip(got, want):
        assert [d.doc_id for d in g] == [d.doc_id for d in w]
    assert store.metrics_snapshot()["metrics"]


@pytest.mark.parametrize("what", ["restore", "snapshot_to", "budget",
                                  "grouped"])
def test_unported_store_features_raise(rag, what, tmp_path):
    """Restore, snapshot_to, device_budget_bytes (items 8, 9) and grouped
    retrieval (item 11) are ported and raise only on misuse, as in the
    reference."""
    docs = rag["store"].docs[:50]
    if what == "restore":
        with pytest.raises(FileNotFoundError):
            DocumentStore.restore(docs, str(tmp_path / "none"),
                                  device="cpu")
    elif what == "budget":
        store = DocumentStore(docs, streaming=True,
                              device_budget_bytes=1 << 20, device="cpu")
        assert store.manager.tier.budget_bytes == 1 << 20
        assert store.manager.cfg.n_shards >= 1
    elif what == "snapshot_to":
        with pytest.raises(ValueError, match="streaming store"):
            rag["store"].snapshot_to(str(tmp_path / "snap"))
    else:
        assert rag["store"].retrieve_grouped([]) == {}


# ---------------------------------------------------------------------------
# Sampling
# ---------------------------------------------------------------------------
def test_temperature_sampling_stays_in_top_k_and_repeats_under_a_seed():
    logits = torch.as_tensor(
        np.random.default_rng(9).normal(size=(4, 1, 50)).astype(np.float32))
    top = torch.topk(logits[:, 0], 5, dim=-1).indices

    def draw(seed):
        gen = torch.Generator().manual_seed(seed)
        return torch.cat([sample_logits(logits, gen, temperature=0.8,
                                        top_k=5) for _ in range(40)], dim=1)

    a, b, c = draw(0), draw(0), draw(1)
    assert a.dtype == torch.int32
    assert torch.equal(a, b) and not torch.equal(a, c)
    for row in range(4):
        assert set(a[row].tolist()) <= set(top[row].tolist())
        assert len(set(a[row].tolist())) > 1         # it does sample
    greedy = sample_logits(logits, None, temperature=0.0)
    assert torch.equal(greedy[:, 0].long(), logits[:, 0].argmax(-1))


def test_generate_with_temperature_repeats_under_a_seed(dense32):
    cfg, _, _, pm, pp = dense32
    prompt = np.ones((2, 4), np.int32)
    a = generate(pm, pp, prompt, max_new=6, temperature=1.0, seed=3)
    b = generate(pm, pp, prompt, max_new=6, temperature=1.0, seed=3)
    assert torch.equal(a, b)
    assert bool(((a >= 0) & (a < cfg.vocab)).all())


def test_serve_launcher_runs_on_the_cpu(capsys):
    from repro_torch.launch.serve import main
    done = main(["--device", "cpu", "--requests", "5", "--slots", "2",
                 "--max-new", "4", "--max-len", "32"])
    assert len(done) == 5
    out = capsys.readouterr().out
    assert "served 5 requests" in out and "gemma3-1b" in out
