"""The port's ``AsyncPlanServer.submit_llm`` (token-level continuous batching
over the paged KV-cache) on the CPU, mirroring the JAX package's
``test_server_continuous_batching_greedy`` and
``test_server_eos_and_cache_pressure``: streamed tokens equal per-sequence
greedy decoding, EOS stops a sequence, a cache too small for the batch
admits in strict order and still drains, nothing fails and no page leaks.
The same traffic through the JAX package's server gives the same tokens.

Params come from a numpy seed (the layout of ``init_lm``), as in
``tests/test_torch_decode.py``; the plans are the port's kernel backend
(the kernels' plain versions on the CPU).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import smoke_config as jsmoke_config
from repro.core.graph import compile_plan as jcompile_plan
from repro.core.graph.passes import optimize as joptimize
from repro.models.transformer_graph import build_decoder_graph as jbuild
from repro.serving import AsyncPlanServer as JAsyncPlanServer
from repro.serving import PagedKVCache as JPagedKVCache
from repro_torch.configs import smoke_config
from repro_torch.convert import lm_params_from_numpy
from repro_torch.core.graph import compile_plan
from repro_torch.core.graph.passes import optimize
from repro_torch.launch import serve as tserve
from repro_torch.models.transformer import forward
from repro_torch.models.transformer_graph import build_decoder_graph, decoder_cache_spec
from repro_torch.obs import metrics as tmetrics
from repro_torch.obs import trace as ttrace
from repro_torch.serving import AsyncPlanServer, PagedKVCache, QueueFullError
from test_torch_decode import numpy_lm, _tree_map


@pytest.fixture(autouse=True)
def _port_registry():
    """Restore the port's own metrics registry around each test."""
    snap = tmetrics.registry().dump_state()
    try:
        yield
    finally:
        tmetrics.registry().load_state(snap)


@pytest.fixture(scope="module")
def lm():
    cfg = smoke_config("qwen2.5-3b")
    pnp = numpy_lm(cfg, seed=1)
    params = lm_params_from_numpy(pnp, device="cpu")
    plans = {}
    for ph in ("prefill", "decode"):
        g = optimize(build_decoder_graph(params, cfg, phase=ph))
        plans[ph] = compile_plan(g, backend="kernel", device="cpu")
    return dict(cfg=cfg, pnp=pnp, params=params, plans=plans)


def _greedy(lm, prompt, steps):
    seq = [int(t) for t in prompt]
    for _ in range(steps):
        logits, _ = forward(lm["params"], lm["cfg"], torch.tensor([seq], dtype=torch.int32))
        seq.append(int(logits[0, -1].argmax()))
    return seq[len(prompt):]


def _server(lm, num_pages, page_size=4, max_batch=2, **kw):
    cache = PagedKVCache(num_pages=num_pages, page_size=page_size,
                         **decoder_cache_spec(lm["cfg"]))
    server = AsyncPlanServer(**kw)
    server.add_llm("lm", prefill=lm["plans"]["prefill"], decode=lm["plans"]["decode"],
                   cache=cache, max_batch=max_batch)
    return server, cache


def _prompts(lm, seed, lens):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, lm["cfg"].vocab, size=n).astype(np.int32) for n in lens]


def test_server_continuous_batching_greedy(lm):
    prompts = _prompts(lm, 3, (3, 7, 5, 9))
    want = [_greedy(lm, p, 3) for p in prompts]
    server, cache = _server(lm, num_pages=24)
    handles = [server.submit_llm("lm", p, max_new_tokens=3) for p in prompts]
    while any(not h.done() for h in handles):
        server.step()
    st = server.stats["per_llm"]["lm"]
    server.close()
    for h, w in zip(handles, want):
        assert h.exception() is None
        assert [int(t) for t in h.result(0)] == w
        assert list(h.tokens_so_far()) == w
    assert st["completed"] == len(prompts) and st["failed"] == 0
    assert st["decode_batches"] >= 1 and st["prefill_batches"] >= 2
    cache.check_invariants()
    assert cache.used_pages == 0  # every page back on the freelist


def test_server_tokens_equal_the_jax_packages_server(lm):
    """The same params, prompts and schedule through both packages'
    servers (reference-backend plans on the JAX side): the same tokens."""
    jcfg = jsmoke_config("qwen2.5-3b")
    jparams = _tree_map(jnp.asarray, lm["pnp"])
    jplans = {ph: jcompile_plan(joptimize(jbuild(jparams, jcfg, phase=ph)), backend="reference")
              for ph in ("prefill", "decode")}
    prompts = _prompts(lm, 8, (6, 4, 8))
    jcache = JPagedKVCache(num_pages=12, page_size=4, **decoder_cache_spec(lm["cfg"]))
    jserver = JAsyncPlanServer()
    jserver.add_llm("lm", prefill=jplans["prefill"], decode=jplans["decode"], cache=jcache,
                    max_batch=2)
    jh = [jserver.submit_llm("lm", p, max_new_tokens=4) for p in prompts]
    while any(not h.done() for h in jh):
        jserver.step()
    jserver.close()
    server, _ = _server(lm, num_pages=12)
    th = [server.submit_llm("lm", p, max_new_tokens=4) for p in prompts]
    while any(not h.done() for h in th):
        server.step()
    server.close()
    assert [list(h.result(0)) for h in th] == [[int(t) for t in h.result(0)] for h in jh]


def test_server_eos_and_cache_pressure(lm):
    """EOS stops a sequence early; a pool too small for the whole batch
    still drains everything, admitting in submission order."""
    rng = np.random.default_rng(4)
    prompt = [int(t) for t in rng.integers(0, lm["cfg"].vocab, 5)]
    first = _greedy(lm, prompt, 1)[0]
    server, cache = _server(lm, num_pages=4, max_batch=4)  # ~one sequence fits at a time
    eos = server.submit_llm("lm", prompt, max_new_tokens=8, eos_id=first)
    rest = [server.submit_llm("lm", rng.integers(0, lm["cfg"].vocab, 6), max_new_tokens=2)
            for _ in range(3)]
    started = {}
    tick = 0
    while any(not h.done() for h in [eos] + rest):
        server.step()
        tick += 1
        for i, h in enumerate([eos] + rest):
            if h.tokens_so_far() and i not in started:
                started[i] = tick
    st = server.stats["per_llm"]["lm"]
    server.close()
    assert [int(t) for t in eos.result(0)] == [first]  # stopped at EOS
    assert all(h.exception() is None and len(h.result(0)) == 2 for h in rest)
    order = [started[i] for i in range(4)]
    assert order == sorted(order) and order[-1] > order[0]  # strict order, queued
    assert st["failed"] == 0 and st["completed"] == 4
    cache.check_invariants()
    assert cache.used_pages == 0


def test_prompt_that_can_never_fit_is_rejected_up_front(lm):
    server, _ = _server(lm, num_pages=2, page_size=2)
    with pytest.raises(ValueError, match="never fit"):
        server.submit_llm("lm", list(range(40)))
    with pytest.raises(ValueError, match="non-empty"):
        server.submit_llm("lm", [])
    with pytest.raises(KeyError):
        server.submit_llm("nope", [1, 2])
    server.close()


def test_queue_full_rejects_and_counts(lm):
    server, _ = _server(lm, num_pages=8, max_queue=2)
    server.submit_llm("lm", [1, 2, 3], max_new_tokens=1)
    server.submit_llm("lm", [4, 5], max_new_tokens=1)
    with pytest.raises(QueueFullError):
        server.submit_llm("lm", [6], max_new_tokens=1)
    assert server.stats["per_llm"]["lm"]["rejected"] == 1
    assert server.close() == 2  # the drain runs both to their end
    assert server.pending() == 0
    with pytest.raises(RuntimeError, match="closed"):
        server.submit_llm("lm", [1])


def test_background_thread_streams_and_close_drains(lm):
    prompts = _prompts(lm, 5, (4, 6, 3))
    want = [_greedy(lm, p, 4) for p in prompts]
    server, cache = _server(lm, num_pages=16, max_batch=3)
    with server:
        server.start()
        assert server.running
        handles = [server.submit_llm("lm", p, max_new_tokens=4) for p in prompts]
        got = [[int(t) for t in h.result(timeout=120)] for h in handles]
    assert got == want
    assert not server.running
    assert server.pending() == 0
    assert server.stats["per_llm"]["lm"]["completed"] == 3
    assert cache.used_pages == 0


def test_a_failing_plan_fails_its_sequences_and_frees_their_pages(lm):
    class Broken:
        graph = lm["plans"]["decode"].graph

        def __call__(self, *args):
            raise RuntimeError("decode exploded")

    cache = PagedKVCache(num_pages=8, page_size=4, **decoder_cache_spec(lm["cfg"]))
    server = AsyncPlanServer()
    server.add_llm("lm", prefill=lm["plans"]["prefill"], decode=Broken(), cache=cache)
    h = server.submit_llm("lm", [3, 1, 4], max_new_tokens=3)
    while not h.done():
        server.step()
    server.close()
    with pytest.raises(RuntimeError, match="exploded"):
        h.result(0)
    assert h.tokens_so_far() == tuple(_greedy(lm, [3, 1, 4], 1))  # the prefill's token
    st = server.stats["per_llm"]["lm"]
    assert st["failed"] == 1 and st["completed"] == 1
    assert cache.used_pages == 0


def test_frame_plans_wait_for_the_serving_slice(lm):
    """Frame plans and LLMs share one server: a frame plan serves beside
    the LLM, the two share one namespace, and add_llm still checks the
    plans' inputs."""
    from repro_torch.core.graph import GraphBuilder

    b = GraphBuilder(["x"])
    w = torch.from_numpy(np.random.default_rng(0).standard_normal((4, 4)).astype(np.float32))
    g = b.build(b.add("linear", "x", params={"w": w}))
    plan = compile_plan(g, backend="kernel", device="cpu")
    server = AsyncPlanServer()
    server.add_plan("app", plan, g.params, 4)
    x = torch.ones(4)
    h = server.submit("app", x)
    assert server.step(force=True) == 1
    assert torch.equal(h.result(0), plan(g.params, x[None])[0])
    with pytest.raises(ValueError, match="already registered"):
        server.add_llm("app", prefill=lm["plans"]["prefill"], decode=lm["plans"]["decode"],
                       cache=PagedKVCache(num_pages=1, page_size=1, n_layers=1,
                                          n_kv_heads=1, head_dim=1))
    with pytest.raises(ValueError, match="expected prefill"):
        server.add_llm("lm", prefill=lm["plans"]["decode"], decode=lm["plans"]["decode"],
                       cache=PagedKVCache(num_pages=1, page_size=1, n_layers=1,
                                          n_kv_heads=1, head_dim=1))


def test_serving_is_traced_and_mirrored_into_the_registry(lm):
    buf = ttrace.start_tracing()
    try:
        server, _ = _server(lm, num_pages=8)
        h = server.submit_llm("lm", [5, 6, 7], max_new_tokens=2)
        while not h.done():
            server.step()
        server.close()
    finally:
        ttrace.stop_tracing()
    names = {e["name"] for e in buf.events}
    assert {"llm_prefill", "llm_decode", "request"} <= names
    counts = tmetrics.registry().label_counts("serving_events_total", "event")
    assert counts["prefill_batches"] >= 1 and counts["completed"] >= 1


def test_serve_cli_llm_smoke_on_cpu(capsys):
    report = tserve.main(["--llm", "--smoke", "--device", "cpu", "--frames", "2",
                          "--new-tokens", "4", "--prompt-len", "6"])
    out = capsys.readouterr().out
    assert "greedy parity ok" in out and "leaked=0" in out
    assert report["steps"] == {"prefill": 20, "decode": 20}
    assert report["parity"]["exact"] and report["stats"]["failed"] == 0
    assert report["tokens"] == 8


def test_serve_cli_needs_exactly_one_mode_and_a_gpu_by_default(monkeypatch):
    with pytest.raises(SystemExit):
        tserve.main(["--llm", "--graph-app", "coloring"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tserve.main(["--llm", "--smoke"])
