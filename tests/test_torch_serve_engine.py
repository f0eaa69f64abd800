"""The port's continuous-batching engine (starvector_tpu_torch/serve/
engine.py) on the CPU, mirroring tests/test_serve_engine.py and
tests/test_spec_engine.py: what the engine emits for greedy traffic must be
the JAX package's offline greedy ids (starvector_tpu.generation.engine.
generate, fp32, the same numpy weights), whatever the admission grouping,
chunking, slot reuse, cache type or tick kind. Sampled traffic is held by
what is exact: min_p = 1 and top_k = 1 reduce sampling to the argmax,
penalties and biases are compared under greedy, and one seed gives one
stream twice.

Two tiny decoders: the 1B's GPTBigCode, and an 8B-shaped StarCoder2 (18
query heads over 2 KV heads: G = 9, a window of 16 that the longer prompts
run past). Every wait has a timeout, so a hang fails the test.
"""

import queue
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from starvector_tpu.generation import beam as jbeam
from starvector_tpu.generation import engine as jengine
from starvector_tpu.models import gpt_bigcode as jgbc
from starvector_tpu.models import starcoder2 as jsc
from starvector_tpu.ops import quantization as jq
from starvector_tpu.ops.layers import DTypePolicy as JPolicy
from starvector_tpu_torch.models import convert
from starvector_tpu_torch.ops.layers import DTypePolicy as TPolicy
from starvector_tpu_torch.ops.quantization import quantize_tree
from starvector_tpu_torch.serve import engine as tengine
from starvector_tpu_torch.serve.engine import Request, ServeEngine

JF32 = JPolicy(compute_dtype=jnp.float32)
TF32 = TPolicy(param_dtype=torch.float32, compute_dtype=torch.float32)
WAIT = 120  # seconds any one event may take
G9 = dict(num_attention_heads=18, num_key_value_heads=2, hidden_size=288, sliding_window=16)
DECODERS = {
    "gpt_bigcode": (jgbc, jgbc.tiny_config(n_positions=512), tengine.gpt_bigcode,
                    tengine.gpt_bigcode.tiny_config(n_positions=512)),
    "starcoder2": (jsc, jsc.tiny_config(**G9), tengine.starcoder2,
                   tengine.starcoder2.tiny_config(**G9)),
}


class Model:
    """One decoder's weights in both packages (projections x 3: greedy
    output neither echoes one token nor never repeats, so speculative
    drafts are partly accepted)."""

    def __init__(self, name: str):
        self.name = name
        self.jmod, self.jcfg, self.tmod, self.tcfg = DECODERS[name]
        tree = jax.tree_util.tree_map(np.asarray,
                                      self.jmod.init_params(self.jcfg, jax.random.PRNGKey(0)))
        for grp in tree["layers"]["attn"], tree["layers"]["mlp"]:
            for p in grp.values():
                p["kernel"] = p["kernel"] * 3.0
        self.tree = tree
        self.jparams = jax.tree_util.tree_map(jnp.asarray, tree)
        self.tparams = convert.from_jax_params(tree)

    def prefix(self, ids) -> np.ndarray:
        """(1, P, E) fp32 token embeddings of ids."""
        return np.array(self.jmod.embed_tokens(self.jparams, jnp.asarray([ids])), np.float32)

    def offline(self, prefix, n: int, params=None, kv_cache_dtype=None) -> list[int]:
        """The JAX package's offline greedy ids: n tokens, no stop."""
        gen = jengine.GenerationConfig(max_new_tokens=n, do_sample=False, pad_token_id=0,
                                       min_new_tokens=n)
        toks, _ = jengine.generate(self.jparams if params is None else params, self.jcfg,
                                   self.name, jnp.asarray(prefix),
                                   jnp.ones(prefix.shape[:2], jnp.int32), gen,
                                   jax.random.PRNGKey(0), policy=JF32,
                                   kv_cache_dtype=kv_cache_dtype)
        return [int(t) for t in np.asarray(toks[0])]

    def engine(self, params=None, **kw) -> ServeEngine:
        kw.setdefault("max_batch", 3)
        kw.setdefault("max_len", 96)
        return ServeEngine(self.tparams if params is None else params, self.tcfg, self.name,
                           policy=TF32, device="cpu", **kw)


@pytest.fixture(scope="module", params=list(DECODERS))
def model(request):
    return Model(request.param)


@pytest.fixture(scope="module")
def gbc():
    return Model("gpt_bigcode")


def collect(req: Request, timeout: float = WAIT) -> tuple[list[int], list]:
    """(the streamed tokens, the final event) of one request."""
    toks = []
    while True:
        kind, payload = req.out_queue.get(timeout=timeout)
        if kind == "token":
            toks.append(payload)
        else:
            return toks, (kind, payload)


def done(req: Request) -> list[int]:
    toks, (kind, payload) = collect(req)
    assert kind == "done", payload
    return payload


def test_single_request_matches_jax(model):
    engine = model.engine()
    try:
        prefix = model.prefix([3, 1, 4])
        req = Request(prefix_embeds=prefix, max_new_tokens=8, do_sample=False)
        engine.submit(req)
        engine.start()
        toks, (kind, out) = collect(req)
    finally:
        engine.stop()
    assert kind == "done" and out == toks == model.offline(prefix, 8)  # streamed one by one


def test_concurrent_requests_match_jax(model):
    """More requests than slots, prompts of 3 to 20 tokens (StarCoder2's
    longer ones past its window of 16): every request equals its own
    offline greedy run (slot reuse, ragged lengths, mixed admission)."""
    engine = model.engine(max_batch=2)
    rng = np.random.default_rng(0)
    prefixes = [model.prefix(rng.integers(0, 512, n).tolist()) for n in (3, 20, 7, 18, 5)]
    try:
        engine.start()
        reqs = [engine.submit(Request(prefix_embeds=p, max_new_tokens=6, do_sample=False))
                for p in prefixes]
        outs = [done(r) for r in reqs]
    finally:
        engine.stop()
    assert outs == [model.offline(p, 6) for p in prefixes]


def test_stop_sequence(gbc):
    engine = gbc.engine()
    prefix = gbc.prefix([3, 1, 4])
    ref = gbc.offline(prefix, 8)
    stop = (ref[1], ref[2])
    try:
        out = engine.generate_sync(Request(prefix_embeds=prefix, max_new_tokens=8,
                                           do_sample=False, stop_sequences=(stop,)), timeout=WAIT)
    finally:
        engine.stop()
    n = next(j + 1 for j in range(1, 8) if (ref[j - 1], ref[j]) == stop)
    assert out == ref[:n]


def test_batched_admission_group(gbc, monkeypatch):
    """Four same-bucket requests queued before the engine starts admit as
    ONE prefill of k = 4 rows; each still equals its own offline run."""
    engine = gbc.engine(max_batch=4)
    groups = []
    orig = engine._prefill

    def spy(embeds_list, Pb):
        groups.append(len(embeds_list))
        return orig(embeds_list, Pb)

    monkeypatch.setattr(engine, "_prefill", spy)
    prefixes = [gbc.prefix([3 + i, 1, 4, 1 + i][: 2 + i]) for i in range(4)]
    try:
        reqs = [engine.submit(Request(prefix_embeds=p, max_new_tokens=5, do_sample=False))
                for p in prefixes]
        engine.start()
        outs = [done(r) for r in reqs]
    finally:
        engine.stop()
    assert groups == [4]
    assert outs == [gbc.offline(p, 5) for p in prefixes]


def test_multichunk_admission_last_token_mid_chunk(gbc):
    """Two prompts of one bucket (300 and 260 tokens: bucket 512) admitted
    together in chunks of 128 (kernel 1's path, later chunks at q_offset >
    0): the 260-token row's last token falls in chunk 2 and the 300-token
    row's in chunk 2 too, at another place, and neither in the last chunk;
    the first tokens come from the right hidden states."""
    engine = gbc.engine(max_batch=2, max_len=640, prefill_chunk=128)
    rng = np.random.default_rng(1)
    prefixes = [gbc.prefix(rng.integers(0, 512, n).tolist()) for n in (300, 260)]
    try:
        reqs = [engine.submit(Request(prefix_embeds=p, max_new_tokens=5, do_sample=False))
                for p in prefixes]
        engine.start()
        outs = [done(r) for r in reqs]
    finally:
        engine.stop()
    assert outs == [gbc.offline(p, 5) for p in prefixes]


def test_logit_bias_and_min_p(gbc):
    """A huge logit_bias forces the greedy output from the first token on
    (admission and tick sampling both apply it); min_p = 1 and top_k = 1
    each turn a sampled request at temperature 5 into the greedy one."""
    engine = gbc.engine()
    prefix = gbc.prefix([3, 1, 4])
    ref = gbc.offline(prefix, 5)
    try:
        biased = engine.generate_sync(Request(prefix_embeds=prefix, max_new_tokens=5,
                                              do_sample=False, logit_bias={7: 1e9}), WAIT)
        min_p = engine.generate_sync(Request(prefix_embeds=prefix, max_new_tokens=5,
                                             do_sample=True, temperature=5.0, top_p=1.0,
                                             min_p=1.0), WAIT)
        top_k = engine.generate_sync(Request(prefix_embeds=prefix, max_new_tokens=5,
                                             do_sample=True, temperature=5.0, top_k=1), WAIT)
    finally:
        engine.stop()
    assert biased == [7] * 5 and min_p == ref and top_k == ref


@pytest.mark.parametrize("knob", ["repetition_penalty", "presence_penalty",
                                  "frequency_penalty", "logit_bias"])
def test_penalties_under_greedy_match_jax(gbc, knob):
    """Each penalty (and a moderate logit_bias) on a greedy request: the
    engine's bias and penalty chain before the argmax, over the prompt's
    ids and the output's counts, equals the JAX package's offline greedy
    generate with the same knob."""
    ids = [3, 1, 4, 1, 5]
    prefix = gbc.prefix(ids)
    value = {"repetition_penalty": 1.8, "presence_penalty": 2.0, "frequency_penalty": 1.5,
             "logit_bias": {9: 3.0, 11: -2.0}}[knob]
    jkw = ({"logit_bias": tuple(value.items())} if knob == "logit_bias" else {knob: value})
    gen = jengine.GenerationConfig(max_new_tokens=10, do_sample=False, pad_token_id=0,
                                   min_new_tokens=10, **jkw)
    ref, _ = jengine.generate(gbc.jparams, gbc.jcfg, gbc.name, jnp.asarray(prefix),
                              jnp.ones(prefix.shape[:2], jnp.int32), gen, jax.random.PRNGKey(0),
                              prompt_ids=jnp.asarray([ids]), policy=JF32)
    ref = [int(t) for t in np.asarray(ref[0])]
    engine = gbc.engine()
    try:
        out = engine.generate_sync(Request(prefix_embeds=prefix, max_new_tokens=10,
                                           do_sample=False, prompt_token_ids=ids,
                                           **{knob: value}), WAIT)
    finally:
        engine.stop()
    assert out == ref
    assert out != gbc.offline(prefix, 10)  # the knob changed the stream


def test_sampling_is_reproducible_for_a_seed(gbc):
    """Sampled streams on one seed: the same tokens from two engines; the
    presence penalty's counts reset when a slot is reused (no repeats within
    either of two requests through one slot)."""
    prefix = gbc.prefix([3, 1, 4])
    outs = []
    for _ in range(2):
        engine = gbc.engine(max_batch=1, seed=5)
        try:
            outs.append([engine.generate_sync(Request(
                prefix_embeds=prefix, max_new_tokens=6, do_sample=True, temperature=1.0,
                top_p=1.0, presence_penalty=1e9), WAIT) for _ in range(2)])
        finally:
            engine.stop()
    assert outs[0] == outs[1]
    for out in outs[0]:
        assert len(set(out)) == len(out), out


def test_int8_weights_and_int8_cache_match_jax(gbc):
    """int8 decoder weights (codes equal to the JAX package's) and an int8
    KV cache, with a multi-chunk admission into it: the engine's greedy ids
    equal the JAX package's offline int8 generate."""
    jparams = jq.quantize_tree(gbc.jparams, min_elems=1 << 10, consume=False)
    tparams = quantize_tree(gbc.tparams, min_elems=1 << 10, consume=False)
    rng = np.random.default_rng(2)
    prefixes = [gbc.prefix([3, 1, 4]), gbc.prefix(rng.integers(0, 512, 150).tolist())]
    engine = gbc.engine(params=tparams, max_len=384, prefill_chunk=64,
                        kv_cache_dtype=torch.int8)
    try:
        engine.start()
        reqs = [engine.submit(Request(prefix_embeds=p, max_new_tokens=6, do_sample=False))
                for p in prefixes]
        outs = [done(r) for r in reqs]
    finally:
        engine.stop()
    assert outs == [gbc.offline(p, 6, params=jparams, kv_cache_dtype=jnp.int8)
                    for p in prefixes]


def test_beam_group_matches_jax_beam_search(model):
    prefix = model.prefix([3, 1, 4, 1, 5])
    ref, ref_len = jbeam.beam_search(model.jparams, jnp.asarray(prefix),
                                     jnp.ones(prefix.shape[:2], jnp.int32), dec_name=model.name,
                                     llm_cfg=model.jcfg, num_beams=2, max_new_tokens=10,
                                     eos_token_id=None, pad_token_id=0, policy=JF32)
    engine = model.engine(max_batch=4)
    try:
        out = engine.generate_sync(Request(prefix_embeds=prefix, max_new_tokens=10,
                                           do_sample=False, num_beams=2), WAIT)
    finally:
        engine.stop()
    assert out == [int(t) for t in np.asarray(ref[0][:int(ref_len[0])])]


def test_beam_and_sampling_stream_concurrently(gbc):
    """A beam group and a greedy stream share the engine: the greedy one
    streams its offline ids while the group decodes, and the group gives
    the offline beam search's."""
    prefix = gbc.prefix([3, 1, 4])
    ref_beam, ref_len = jbeam.beam_search(gbc.jparams, jnp.asarray(prefix),
                                          jnp.ones(prefix.shape[:2], jnp.int32),
                                          dec_name=gbc.name, llm_cfg=gbc.jcfg, num_beams=2,
                                          max_new_tokens=8, eos_token_id=None, pad_token_id=0,
                                          policy=JF32)
    engine = gbc.engine(max_batch=4)
    try:
        greedy = engine.submit(Request(prefix_embeds=prefix, max_new_tokens=8, do_sample=False))
        beam = engine.submit(Request(prefix_embeds=prefix, max_new_tokens=8, do_sample=False,
                                     num_beams=2))
        engine.start()
        outs = [done(greedy), done(beam)]
    finally:
        engine.stop()
    assert outs[0] == gbc.offline(prefix, 8)
    assert outs[1] == [int(t) for t in np.asarray(ref_beam[0][:int(ref_len[0])])]


def test_beam_wider_than_the_slots_fails_cleanly(gbc):
    engine = gbc.engine(max_batch=2)
    try:
        req = engine.submit(Request(prefix_embeds=gbc.prefix([3, 1]), max_new_tokens=4,
                                    num_beams=3))
        kind, payload = req.out_queue.get(timeout=WAIT)
        # the engine still serves
        out = engine.generate_sync(Request(prefix_embeds=gbc.prefix([3, 1]), max_new_tokens=4,
                                           do_sample=False), WAIT)
    finally:
        engine.stop()
    assert kind == "error" and "num_beams" in payload
    assert out == gbc.offline(gbc.prefix([3, 1]), 4)


def test_a_failing_request_does_not_stop_the_others(gbc, monkeypatch):
    """A failed beam step may have half-written the cache: the requests it
    touched fail (the beam group, and the greedy stream beside it, which
    must not go on from a rebuilt cache), a request whose prefix cannot be
    admitted fails alone, and the engine then serves the next request
    exactly."""
    engine = gbc.engine(max_batch=3, max_len=320)
    prefix = gbc.prefix([3, 1, 4])

    def boom(*a, **k):
        raise RuntimeError("injected beam failure")

    monkeypatch.setattr(tengine, "_beam_step", boom)
    try:
        engine.start()
        greedy = engine.submit(Request(prefix_embeds=prefix, max_new_tokens=300,
                                       do_sample=False))
        assert greedy.out_queue.get(timeout=WAIT)[0] == "token"  # admitted and decoding
        beam = engine.submit(Request(prefix_embeds=prefix, max_new_tokens=8, num_beams=2))
        outcomes = [collect(r)[1][0] for r in (beam, greedy)]
        monkeypatch.undo()
        bad = engine.submit(Request(prefix_embeds=np.zeros((1, 3, 7), np.float32),
                                    max_new_tokens=4, do_sample=False))  # wrong width
        bad_kind = collect(bad)[1][0]
        out = engine.generate_sync(Request(prefix_embeds=prefix, max_new_tokens=6,
                                           do_sample=False), WAIT)
    finally:
        engine.stop()
    assert outcomes == ["error", "error"] and bad_kind == "error"
    assert out == gbc.offline(prefix, 6)


def test_speculative_ticks_match_jax(model):
    """spec_drafts = 4: prompt ids seeded with the true future (every draft
    right), with wrong continuations (every draft rejected), and with none;
    each stream equals offline greedy, and the accepted drafts cut the
    ticks."""
    prefix = model.prefix([3, 1, 4])
    N = 24
    ref = model.offline(prefix, N)
    bad = [(t + 7) % 512 for t in ref]
    engine = model.engine(max_len=128, spec_drafts=4)
    try:
        engine.start()
        right = engine.submit(Request(prefix_embeds=prefix, max_new_tokens=N, do_sample=False,
                                      prompt_token_ids=[3, 1, 4] + ref))
        out_right = done(right)
        stats = engine.stats()
        wrong = engine.submit(Request(prefix_embeds=prefix, max_new_tokens=N, do_sample=False,
                                      prompt_token_ids=[3, 1, 4] + ref[:2] + bad[2:]))
        none = engine.submit(Request(prefix_embeds=prefix, max_new_tokens=N, do_sample=False))
        outs = [done(wrong), done(none)]
    finally:
        engine.stop()
    assert out_right == ref and outs == [ref, ref]
    assert stats["spec_ticks"] > 0 and stats["spec_extra_tokens"] > 0
    assert stats["ticks"] <= N // 2


def test_speculative_accept_margin(gbc):
    """accept_margin = 1e9 accepts no draft (one token a round), 0 accepts
    freely: both give the offline greedy ids."""
    prefix = gbc.prefix([3, 1, 4])
    N = 16
    ref = gbc.offline(prefix, N)
    extra = {}
    for margin in (0.0, 1e9):
        engine = gbc.engine(max_batch=2, spec_drafts=4, spec_accept_margin=margin)
        try:
            out = engine.generate_sync(Request(prefix_embeds=prefix, max_new_tokens=N,
                                               do_sample=False, prompt_token_ids=[3, 1, 4] + ref),
                                       WAIT)
            extra[margin] = engine.stats()["spec_extra_tokens"]
        finally:
            engine.stop()
        assert out == ref
    assert extra[1e9] == 0 and extra[0.0] > 0


def test_speculative_with_sampled_traffic_and_beams(gbc):
    """A greedy, a sampled and a beam request under speculative ticks: the
    greedy stream stays exact, the others finish."""
    prefix = gbc.prefix([3, 1, 4])
    ref = gbc.offline(prefix, 12)
    engine = gbc.engine(max_batch=4, spec_drafts=3, steps_per_tick=2)
    try:
        reqs = [engine.submit(Request(prefix_embeds=prefix, max_new_tokens=12, do_sample=False,
                                      prompt_token_ids=[3, 1, 4] + ref)),
                engine.submit(Request(prefix_embeds=gbc.prefix([7, 8]), max_new_tokens=12,
                                      do_sample=True, temperature=1.0, top_p=0.9)),
                engine.submit(Request(prefix_embeds=prefix, max_new_tokens=6, do_sample=False,
                                      num_beams=2))]
        engine.start()
        outs = [done(r) for r in reqs]
    finally:
        engine.stop()
    assert outs[0] == ref and len(outs[1]) == 12 and len(outs[2]) > 0


def test_spec_drafts_must_fit_the_window():
    m = DECODERS["starcoder2"]
    params = convert.from_jax_params(jax.tree_util.tree_map(
        np.asarray, m[0].init_params(m[1], jax.random.PRNGKey(0))))
    with pytest.raises(ValueError, match="sliding window"):
        ServeEngine(params, m[3], "starcoder2", max_batch=2, max_len=64, policy=TF32,
                    spec_drafts=16, device="cpu")


def test_warmup_and_stats(gbc):
    """warmup() admits and decodes dummies for each group size, leaves no
    slot held and the counters as they were; the engine then serves."""
    engine = gbc.engine(spec_drafts=2)
    try:
        engine.warmup([8], group_sizes=[1, 2], timeout=WAIT)
        st = engine.stats()
        assert engine.num_active == 0 and st["tokens_emitted"] == 0 and st["spec_ticks"] == 0
        prefix = gbc.prefix([5, 6])
        out = engine.generate_sync(Request(prefix_embeds=prefix, max_new_tokens=6,
                                           do_sample=False), WAIT)
    finally:
        engine.stop()
    assert out == gbc.offline(prefix, 6)
    assert engine.stats()["tokens_emitted"] == 6 and engine.queue_length == 0


def test_stop_fails_queued_requests(gbc):
    engine = gbc.engine()
    req = engine.submit(Request(prefix_embeds=gbc.prefix([3]), max_new_tokens=4))
    engine.stop()
    t0 = time.time()
    assert req.out_queue.get(timeout=WAIT) == ("error", "engine stopped")
    assert time.time() - t0 < WAIT
    with pytest.raises(queue.Empty):
        req.out_queue.get_nowait()
