"""The port's serving engine on the CPU at toy size, in f32: against the
port's own batch-1 greedy generation, and against the JAX package's
`ServingEngine` on bridged params and the same requests.

Tokens must be equal, token for token: both sides run the same f32
arithmetic on tiny models, and an argmax flips only where two logits lie
within summation noise of each other. Each engine test runs over the
float cache (f32 at toy size, standing for the bf16 slots of the card) and,
where it applies, the int8 cache.
"""

import dataclasses
import json
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hsenet_tpu.eval.generate import make_greedy_generate_llm_only as jax_generate_llm
from hsenet_tpu.models.mllm import HSENetVLM as JaxVLM
from hsenet_tpu.models.phi3 import Phi3ForCausalLM as JaxLM
from hsenet_tpu.serving import ServingEngine as JaxEngine
from hsenet_torch.cli import serve as tserve
from hsenet_torch.eval.generate import (
    make_greedy_generate,
    make_greedy_generate_llm_only,
)
from hsenet_torch.models.mllm import HSENetVLM
from hsenet_torch.models.phi3 import Phi3ForCausalLM
from hsenet_torch.serving import ServingEngine, engine_generate_fn, run_open_loop
from test_torch_common import (
    TINY_LLM,
    TINY_VLM,
    fill_zero_inits,
    load_flax,
    to_torch_config,
)

torch.set_num_threads(1)

LLM = dataclasses.replace(TINY_LLM, vocab_size=96, tie_word_embeddings=False)
MAX_NEW = 12
PAD = 0
CACHES = {"float": (jnp.float32, torch.float32), "int8": (jnp.int8, torch.int8)}
LLM_KW = dict(pad_token_id=PAD, num_slots=2, prompt_cap=16,
              max_new_tokens=MAX_NEW, chunk_size=4)
VLM_KW = dict(pad_token_id=PAD, num_slots=2, prompt_cap=24,
              max_new_tokens=MAX_NEW, chunk_size=4, multimodal=True)
CLI_SMALL = ["--num-requests", "5", "--slots", "2", "--chunk", "4",
             "--max-new-tokens", "10"]


@pytest.fixture(scope="module")
def llm():
    rng = np.random.default_rng(0)
    prompts = [rng.integers(3, LLM.vocab_size, size=n) for n in (5, 9, 14, 7, 11)]
    jm = JaxLM(LLM, dtype=jnp.float32)
    params = fill_zero_inits(
        jm.init(jax.random.PRNGKey(0), jnp.asarray(prompts[0][None, :])), 0)
    tm = load_flax(
        Phi3ForCausalLM(to_torch_config(LLM), dtype=torch.float32, device="cpu"),
        params)
    return dict(prompts=prompts, jm=jm, params=params, tm=tm)


@pytest.fixture(scope="module")
def vlm():
    rng = np.random.default_rng(1)
    n_img = TINY_VLM.num_image_tokens
    volumes = [rng.standard_normal((1, 1, 4, 16, 16)).astype(np.float32)
               for _ in range(2)]
    slices = [rng.standard_normal((1, 2, 16)).astype(np.float32) for _ in range(2)]

    def prompt(n_text):
        ids = rng.integers(5, TINY_VLM.llm.vocab_size, size=1 + n_img + n_text)
        ids[0] = 1  # BOS
        ids[1:1 + n_img] = 4  # the placeholder block, byte-identical
        return ids

    # five questions over two scans: scan 0 asked three times
    traffic = [(prompt(n), v) for n, v in ((3, 0), (6, 1), (4, 0), (5, 0), (2, 1))]
    jm = JaxVLM(TINY_VLM, dtype=jnp.float32)
    params = fill_zero_inits(jax.jit(jm.init)(
        jax.random.PRNGKey(1), jnp.asarray(traffic[0][0][None, :]),
        jnp.asarray(volumes[0]), jnp.asarray(slices[0])), 1)
    tm = load_flax(
        HSENetVLM(to_torch_config(TINY_VLM), dtype=torch.float32, device="cpu"),
        params)
    return dict(traffic=traffic, volumes=volumes, slices=slices, jm=jm,
                params=params, tm=tm)


def _truncate(row, eos):
    """A generate row as a server streams it: through EOS, inclusive."""
    out = []
    for t in row:
        out.append(int(t))
        if t == eos:
            break
    return out


def _batch1(tm, prompt, eos, cache_dtype, max_new=MAX_NEW):
    gen = make_greedy_generate_llm_only(
        tm, max_new_tokens=max_new, eos_token_id=eos, pad_token_id=PAD,
        cache_dtype=cache_dtype)
    row = gen(torch.as_tensor(prompt[None, :]), torch.tensor([len(prompt)]))[0]
    return _truncate(row.numpy(), eos)


def _mid_eos(tm, prompt, cache_dtype):
    """A token the model emits third for `prompt`: as EOS it freezes that
    request mid-chunk."""
    return _batch1(tm, prompt, -1, cache_dtype)[2]


def _drain_vlm(engine, vlm):
    uids = [engine.submit(p, volume=vlm["volumes"][v], slice_features=vlm["slices"][v])
            for p, v in vlm["traffic"]]
    results = engine.run_until_drained()
    return [results[u] for u in uids]


@pytest.mark.parametrize("cache", list(CACHES))
def test_engine_tokens_equal_batch1_greedy(llm, cache):
    """Five requests through two slots (slot reuse, frozen rows, an EOS
    inside a chunk): each request's tokens equal the port's batch-1 greedy
    generation with the same kind of cache."""
    tdtype = CACHES[cache][1]
    eos = _mid_eos(llm["tm"], llm["prompts"][0], tdtype)
    eng = ServingEngine(llm["tm"], eos_token_id=eos, cache_dtype=tdtype,
                        device="cpu", **LLM_KW)
    uids = [eng.submit(p) for p in llm["prompts"]]
    results = eng.run_until_drained()
    assert set(results) == set(uids)
    for uid, prompt in zip(uids, llm["prompts"]):
        assert results[uid] == _batch1(llm["tm"], prompt, eos, tdtype), uid
    assert results[uids[0]][-1] == eos and len(results[uids[0]]) == 3
    assert eng.utilization > 0.4
    assert eng.pending == 0 and eng.active == 0
    # never-used and frozen rows keep their lengths inside the cache
    assert int(eng._cache.lengths.max()) <= eng.capacity


@pytest.mark.parametrize("cache", list(CACHES))
def test_llm_only_generate_equals_jax(llm, cache):
    jdtype, tdtype = CACHES[cache]
    prompt = llm["prompts"][2]
    want = np.asarray(jax_generate_llm(
        llm["jm"], max_new_tokens=MAX_NEW, eos_token_id=2, pad_token_id=PAD,
        cache_dtype=jdtype,
    )(llm["params"], jnp.asarray(prompt[None, :]),
      jnp.asarray([len(prompt)], jnp.int32)))
    got = make_greedy_generate_llm_only(
        llm["tm"], max_new_tokens=MAX_NEW, eos_token_id=2, pad_token_id=PAD,
        cache_dtype=tdtype,
    )(torch.as_tensor(prompt[None, :]), torch.tensor([len(prompt)]))
    assert got.dtype == torch.int32 and got.shape == (1, MAX_NEW)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("cache", list(CACHES))
def test_engine_tokens_equal_jax_engine_llm_only(llm, cache):
    """The same requests and budgets through the JAX engine and the
    port's, on bridged params."""
    jdtype, tdtype = CACHES[cache]
    eos = _mid_eos(llm["tm"], llm["prompts"][1], tdtype)
    budgets = [MAX_NEW, 9, 5, MAX_NEW, 7]
    jeng = JaxEngine(llm["jm"], llm["params"], eos_token_id=eos,
                     cache_dtype=jdtype, **LLM_KW)
    teng = ServingEngine(llm["tm"], eos_token_id=eos, cache_dtype=tdtype,
                         device="cpu", **LLM_KW)
    juids = [jeng.submit(p, b) for p, b in zip(llm["prompts"], budgets)]
    tuids = [teng.submit(p, b) for p, b in zip(llm["prompts"], budgets)]
    want, got = jeng.run_until_drained(), teng.run_until_drained()
    for ju, tu in zip(juids, tuids):
        assert got[tu] == want[ju], tu
    assert teng.steps_run == jeng.steps_run
    assert teng.slot_steps_used == jeng.slot_steps_used
    assert teng.utilization == pytest.approx(jeng.utilization)
    # frozen rows: a slot that is done or free keeps its cache length while
    # the others decode on, exactly as in the JAX engine
    np.testing.assert_array_equal(teng._cache.lengths.numpy(),
                                  np.asarray(jeng._cache.lengths))
    np.testing.assert_array_equal(teng._done.numpy(), np.asarray(jeng._done))


@pytest.mark.parametrize("caches_on", [False, True], ids=["nocache", "lru"])
@pytest.mark.parametrize("cache", list(CACHES))
def test_engine_tokens_equal_jax_engine_multimodal(vlm, cache, caches_on):
    """Full-VLM serving, with both admission caches off (towers + full
    prefill per request) and on (feature LRU and KV-prefix LRU, int8 codes
    with their scales): tokens and hit counts equal the JAX engine's."""
    jdtype, tdtype = CACHES[cache]
    lru = dict(volume_cache_size=2, kv_prefix_cache_size=2) if caches_on else {}
    jeng = JaxEngine(vlm["jm"], vlm["params"], eos_token_id=2,
                     cache_dtype=jdtype, **VLM_KW, **lru)
    teng = ServingEngine(vlm["tm"], eos_token_id=2, cache_dtype=tdtype,
                         device="cpu", **VLM_KW, **lru)
    want, got = _drain_vlm(jeng, vlm), _drain_vlm(teng, vlm)
    assert got == want
    for name in ("encode_hits", "encode_misses", "prefix_hits", "prefix_misses"):
        assert getattr(teng, name) == getattr(jeng, name), name
    if caches_on:
        assert (teng.prefix_misses, teng.prefix_hits) == (2, 3)
        # a prefix hit never reaches the feature cache
        assert (teng.encode_misses, teng.encode_hits) == (2, 0)


@pytest.mark.parametrize("cache", list(CACHES))
@pytest.mark.parametrize("lru", ["volume", "prefix", "both"])
def test_admission_caches_keep_tokens(vlm, cache, lru):
    """Token identity with the caches off, and the hit counts of each LRU
    alone: one encode per distinct scan with the volume cache, one full
    prefill per distinct scan with the prefix cache."""
    tdtype = CACHES[cache][1]
    kw = dict(eos_token_id=2, cache_dtype=tdtype, device="cpu", **VLM_KW)
    cold = _drain_vlm(ServingEngine(vlm["tm"], **kw), vlm)
    sizes = dict(volume_cache_size=2 if lru != "prefix" else 0,
                 kv_prefix_cache_size=2 if lru != "volume" else 0)
    warm_eng = ServingEngine(vlm["tm"], **kw, **sizes)
    assert _drain_vlm(warm_eng, vlm) == cold
    if lru == "volume":
        assert (warm_eng.encode_misses, warm_eng.encode_hits) == (2, 3)
        assert (warm_eng.prefix_misses, warm_eng.prefix_hits) == (0, 0)
    else:
        assert (warm_eng.prefix_misses, warm_eng.prefix_hits) == (2, 3)
    if cache == "int8" and lru != "volume":
        pkv = next(iter(warm_eng._kv_prefix_cache.values()))
        n = 1 + TINY_VLM.num_image_tokens
        assert len(pkv) == 4 and pkv[0].dtype == torch.int8
        assert pkv[0].shape[3] == n and pkv[2].shape[3] == n  # token axis 3
        assert pkv[2].dtype == torch.float32 and pkv[2].ndim == 4


def test_lru_eviction_and_cache_argument_checks(vlm, llm):
    eng = ServingEngine(vlm["tm"], eos_token_id=2, cache_dtype=torch.float32,
                        device="cpu", volume_cache_size=1,
                        kv_prefix_cache_size=1, **VLM_KW)
    _drain_vlm(eng, vlm)
    # scans alternate 0, 1, 0, 0, 1 through LRUs of one entry
    assert (eng.prefix_misses, eng.prefix_hits) == (4, 1)
    assert len(eng._kv_prefix_cache) == 1 and len(eng._vol_cache) == 1
    for name in ("volume_cache_size", "kv_prefix_cache_size"):
        with pytest.raises(ValueError, match="multimodal"):
            ServingEngine(llm["tm"], eos_token_id=2, device="cpu", **{name: 2})


def test_incremental_step_and_budgets(llm):
    """`step()` admits at chunk boundaries, returns what finished in that
    cycle, and honours per-request budgets (capped at the engine's)."""
    eng = ServingEngine(llm["tm"], eos_token_id=-1, cache_dtype=torch.float32,
                        device="cpu", **LLM_KW)
    assert eng.step() == {} and eng.steps_run == 0  # nothing to do
    budgets = [3, 6, 100]
    uids = [eng.submit(p, b) for p, b in zip(llm["prompts"], budgets)]
    assert eng.pending == 3 and eng.active == 0
    first = eng.step()  # two slots: requests 0 and 1 admitted, one chunk of 4
    assert set(first) == {uids[0]} and len(first[uids[0]]) == 3
    assert eng.active == 1 and eng.pending == 1 and eng.steps_run == 4
    second = eng.step()  # request 2 takes the freed slot
    assert set(second) == {uids[1]} and len(second[uids[1]]) == 6
    rest = eng.run_until_drained()
    assert len(rest[uids[2]]) == MAX_NEW  # 100 is capped at max_new_tokens
    whole = _batch1(llm["tm"], llm["prompts"][2], -1, torch.float32)
    assert rest[uids[2]] == whole
    assert first[uids[0]] == _batch1(llm["tm"], llm["prompts"][0], -1,
                                     torch.float32)[:3]


def test_submit_checks(llm, vlm):
    eng = ServingEngine(llm["tm"], eos_token_id=2, device="cpu", **LLM_KW,
                        cache_dtype=torch.float32)
    with pytest.raises(ValueError, match="prompt_cap"):
        eng.submit(np.arange(17))
    with pytest.raises(ValueError, match="multimodal"):
        eng.submit([1, 2, 3], volume=vlm["volumes"][0])
    veng = ServingEngine(vlm["tm"], eos_token_id=2, device="cpu", **VLM_KW,
                         cache_dtype=torch.float32)
    with pytest.raises(ValueError, match="requires volume"):
        veng.submit(vlm["traffic"][0][0])
    with pytest.raises(ValueError, match="does not match"):
        veng.submit(vlm["traffic"][0][0], volume=np.zeros((1, 1, 4, 16, 8)))


@pytest.mark.parametrize("cache", list(CACHES))
def test_open_loop_equals_the_drain(llm, cache):
    tdtype = CACHES[cache][1]
    kw = dict(eos_token_id=2, cache_dtype=tdtype, device="cpu", **LLM_KW)
    drain = ServingEngine(llm["tm"], **kw)
    uids = [drain.submit(p) for p in llm["prompts"]]
    want = drain.run_until_drained()
    eng = ServingEngine(llm["tm"], **kw)
    requests = [dict(prompt_ids=p) for p in llm["prompts"]]
    offsets = [0.0, 0.0, 0.02, 0.05, 0.05]
    got, makespan = run_open_loop(eng, requests, offsets)
    assert [got[u] for u in sorted(got)] == [want[u] for u in uids]
    assert makespan >= 0.05 and len(eng.ttfts) == 5
    with pytest.raises(ValueError, match="differ in length"):
        run_open_loop(eng, requests, offsets[:2])


def test_engine_generate_fn_equals_make_greedy_generate(vlm):
    """The eval-harness adapter: rows become requests, the output is
    repacked in row order with pad after EOS."""
    prompts = [p for p, _ in vlm["traffic"][:3]]
    width = max(map(len, prompts))
    ids = np.zeros((3, width), np.int64)
    for row, p in enumerate(prompts):
        ids[row, :len(p)] = p
    lens = np.asarray([len(p) for p in prompts], np.int32)
    vols = np.concatenate([vlm["volumes"][v] for _, v in vlm["traffic"][:3]])
    sls = np.concatenate([vlm["slices"][v] for _, v in vlm["traffic"][:3]])
    args = [torch.as_tensor(a) for a in (ids, lens, vols, sls)]
    probe = make_greedy_generate(vlm["tm"], max_new_tokens=MAX_NEW,
                                 eos_token_id=-1, cache_dtype=torch.float32)(*args)
    eos = int(probe[1, 3])
    want = make_greedy_generate(
        vlm["tm"], max_new_tokens=MAX_NEW, eos_token_id=eos, pad_token_id=PAD,
        cache_dtype=torch.float32)(*args)
    eng = ServingEngine(vlm["tm"], eos_token_id=eos, cache_dtype=torch.float32,
                        device="cpu", **VLM_KW)
    got = engine_generate_fn(eng)(*args)
    assert got.dtype == torch.int32 and got.shape == (3, MAX_NEW)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    assert (want[1, 4:] == PAD).all()  # row 1 froze after its EOS


def test_latency_stats_and_backdating(llm):
    eng = ServingEngine(llm["tm"], eos_token_id=2, cache_dtype=torch.float32,
                        device="cpu", **LLM_KW)
    assert eng.latency_stats() == {} and eng.hbm_stats() == {}
    now = time.perf_counter()
    eng.submit(llm["prompts"][0], 6)
    eng.submit(llm["prompts"][1], 6, submitted_at=now - 100.0)
    eng.run_until_drained()
    stats = eng.latency_stats()
    assert set(stats) == {"p50_s", "p95_s", "max_s", "mean_s", "ttft_p50_s",
                          "ttft_p99_s", "ttft_max_s", "tpot_p50_s", "tpot_p99_s"}
    # the backdated request carries its 100 s of queueing in TTFT and latency
    assert 100.0 < stats["ttft_max_s"] < 160.0 and stats["max_s"] >= stats["ttft_max_s"]
    assert min(eng.ttfts) < 50.0
    assert 0 < stats["tpot_p50_s"] <= stats["tpot_p99_s"]
    assert eng.hbm_stats() == {}  # no device memory to report on the CPU


@pytest.mark.parametrize(
    "kwargs,slice_name",
    # speculative decoding is ported; speculative sampling waits for the
    # sampling slice
    [(dict(speculative=True, do_sample=True), "sampling"),
     (dict(do_sample=True), "sampling"),
     (dict(mesh=object()), "parallel")],
    ids=["speculative", "do_sample", "mesh"],
)
def test_engine_options_of_later_slices_raise(llm, kwargs, slice_name):
    with pytest.raises(NotImplementedError, match=slice_name):
        ServingEngine(llm["tm"], eos_token_id=2, device="cpu", **kwargs)


@pytest.mark.parametrize("entry", ["engine", "cli"])
def test_serving_entry_points_refuse_missing_cuda(llm, entry):
    """Without `device="cpu"` the engine and the CLI's `main` ask for the
    card and raise where there is none."""
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA; the check is for hosts without it")
    with pytest.raises(RuntimeError, match="CUDA"):
        if entry == "engine":
            ServingEngine(llm["tm"], eos_token_id=2)
        else:
            tserve.main(["--synthetic", *CLI_SMALL])


def test_cli_synthetic_multimodal(capsys, tmp_path):
    out = tmp_path / "out.jsonl"
    summary = tserve.main(["--synthetic", "--prompt-cap", "80",
                           "--distinct-volumes", "2", "--vol-cache", "2",
                           "--kv-prefix-cache", "2", "--output", str(out),
                           *CLI_SMALL], device="cpu")
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed == summary
    assert summary["requests"] == 5 and summary["slots"] == 2 and summary["tp"] == 1
    assert summary["prefix_misses"] == 2 and summary["prefix_hits"] == 3
    assert summary["encode_misses"] == 2 and summary["encode_hits"] == 0
    assert {"tokens", "wall_s", "tok_per_s", "slot_utilization",
            "latency_p50_s", "latency_ttft_p50_s"} <= set(summary)
    rows = [json.loads(line) for line in out.read_text().splitlines()]
    assert len(rows) == 5 and sum(len(r["tokens"]) for r in rows) == summary["tokens"]
    assert all(0 <= t < 512 for r in rows for t in r["tokens"])


@pytest.mark.parametrize("kv_int8", [False, True], ids=["float", "kv-int8"])
def test_cli_synthetic_llm_only(capsys, kv_int8):
    summary = tserve.main(["--synthetic", "--llm-only", "--prompt-cap", "32",
                           *CLI_SMALL, *(["--kv-int8"] if kv_int8 else [])], device="cpu")
    assert summary["requests"] == 5 and 4 * 5 <= summary["tokens"] <= 10 * 5
    assert "prefix_hits" not in summary and "encode_hits" not in summary


def test_cli_requests_file(tmp_path, capsys):
    req = tmp_path / "req.jsonl"
    req.write_text("\n".join(json.dumps(
        {"id": f"r{i}", "prompt_ids": [1, 7 + i, 9, 11], "max_new": 4 + i}
    ) for i in range(3)) + "\n")
    out = tmp_path / "out.jsonl"
    summary = tserve.main(["--synthetic", "--llm-only", "--requests", str(req),
                           "--output", str(out), "--prompt-cap", "16",
                           "--eos-token-id", "-1", *CLI_SMALL], device="cpu")
    rows = {r["id"]: r["tokens"] for r in map(json.loads, out.read_text().splitlines())}
    assert {k: len(v) for k, v in rows.items()} == {"r0": 4, "r1": 5, "r2": 6}
    assert summary["tokens"] == 15


@pytest.mark.parametrize("flag", ["--vol-cache", "--kv-prefix-cache"])
def test_cli_rejects_caches_with_llm_only(flag, capsys):
    with pytest.raises(SystemExit):
        tserve.main(["--synthetic", "--llm-only", flag, "2", *CLI_SMALL], device="cpu")
    assert "multimodal" in capsys.readouterr().err


@pytest.mark.parametrize(
    "flags,slice_name",
    [(["--checkpoint", "ckpt"], "checkpoint"), (["--tp", "2"], "parallel"),
     (["--speculative", "--do-sample"], "sampling"), (["--do-sample"], "sampling")],
    ids=["checkpoint", "tp", "speculative", "do-sample"],
)
def test_cli_options_of_later_slices_raise(flags, slice_name):
    with pytest.raises(NotImplementedError, match=slice_name):
        tserve.main(["--synthetic", *flags, *CLI_SMALL], device="cpu")
