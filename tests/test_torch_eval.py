"""The port's evaluation slice on the CPU against the JAX package: the NLG,
VQA and entity metrics, the MRG/VQA datasets, the MRG and VQA harnesses and
the evaluate CLI end to end.

Metrics, datasets and harness results must be exactly equal (`==` on
floats): both packages run the same Python arithmetic in one environment,
so METEOR takes nltk's branch (or its fallback) in both alike. The CLI runs
on bridged weights, which are the JAX CLI's own PRNGKey(0) init on the
first synthetic batch, written with the port's `save_params` and read back
through `--checkpoint`; the generated token ids (recorded where each
tokenizer decodes them) must equal the JAX CLI's, and so must every metric.
"""

import argparse
import contextlib
import io
import json
import os
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hsenet_tpu.data.datasets as jds
import hsenet_tpu.data.prompts as jprompts
import hsenet_tpu.eval.metrics as jmetrics
import hsenet_tpu.eval.ratescore as jrate
import hsenet_torch.data.datasets as tds
import hsenet_torch.eval.metrics as tmetrics
import hsenet_torch.eval.ratescore as trate
from hsenet_tpu.cli import evaluate as jeval
from hsenet_tpu.cli.train_vlm import build_vlm_config as jax_vlm_config
from hsenet_tpu.eval.mrg import evaluate_mrg as jax_mrg
from hsenet_tpu.eval.vqa import evaluate_vqa as jax_vqa
from hsenet_tpu.models.clip import CLIPModel as JaxCLIP
from hsenet_tpu.models.mllm import HSENetVLM as JaxVLM
from hsenet_torch.bridge import flax_to_torch
from hsenet_torch.cli import evaluate as teval
from hsenet_torch.eval.mrg import CSV_FIELDS, evaluate_mrg
from hsenet_torch.eval.vqa import ANATOMY_REGIONS, evaluate_vqa
from hsenet_torch.utils.checkpoint import save_params

torch.set_num_threads(1)


# ------------------------------------------------------------ report pairs


def _sentences(rng):
    """Seeded report sentences from the template lists and the entity
    fallback's vocabulary, with negation cues, punctuation and empties."""
    findings = jrate._FINDINGS
    anatomy = list(jrate._vocabulary())
    cues = ["no", "without", "no evidence of", "free of", "not", "", "but"]
    out = []
    for _ in range(12):
        words = [str(rng.choice(cues)), str(rng.choice(findings)), "in the",
                 str(rng.choice(anatomy))]
        if rng.random() < 0.4:
            words += [";", "however", str(rng.choice(findings))]
        out.append(" ".join(w for w in words if w) + str(rng.choice([".", ",", "", " ."])))
    out += list(rng.choice(jprompts.Caption_templates, 6))
    out += [t.format(abnormality=str(rng.choice(findings)))
            for t in rng.choice(jprompts.VQA_location_templates, 6)]
    out += ["", "   ", "(Heart) size is 'normal'.", "No acute abnormality."]
    return out


def _pairs(n=30, seed=0):
    rng = np.random.default_rng(seed)
    pool = _sentences(rng)
    pairs = []
    for i in range(n):
        pred = " ".join(str(s) for s in rng.choice(pool, rng.integers(0, 4)))
        ref = " ".join(str(s) for s in rng.choice(pool, rng.integers(0, 4)))
        pairs.append((pred, ref if i % 7 else pred))  # some identical pairs
    pairs[3] = ("", "")
    pairs[4] = ("left lung nodule", "")
    return pairs


PAIRS = _pairs()


def test_pairs_cover_the_cases():
    """The list holds entities both present and negated, empty strings and
    punctuation, so each metric branch is reached."""
    polarities = {pol for p, r in PAIRS for _, pol in trate.extract_entities(p + " " + r)}
    assert polarities == {"present", "absent"}
    assert any(p == "" for p, _ in PAIRS) and any(r == "" for _, r in PAIRS)
    assert any(p == r and p for p, r in PAIRS)


def test_nlg_and_entity_metrics_equal_jax():
    for pred, ref in PAIRS:
        assert tmetrics.nlg_metrics(pred, ref) == jmetrics.nlg_metrics(pred, ref)
        assert tmetrics.bleu_n(pred, ref, smooth=True) == jmetrics.bleu_n(
            pred, ref, smooth=True)
        assert trate.entity_f1(pred, ref) == jrate.entity_f1(pred, ref)
        assert trate.extract_entities(pred) == jrate.extract_entities(pred)
        assert tmetrics.simple_tokenize(pred) == jmetrics.simple_tokenize(pred)
    preds, refs = zip(*PAIRS)
    for name in ("containment_accuracy", "exact_match_accuracy"):
        assert getattr(tmetrics, name)(preds, refs) == getattr(jmetrics, name)(
            preds, refs)
    assert trate.compute_ratescore(preds, refs, allow_fallback=True) == \
        jrate.compute_ratescore(preds, refs, allow_fallback=True)
    assert trate.active_scorer_name() == jrate.active_scorer_name()


def test_running_means_and_bert_score_equal_jax():
    t, j = tmetrics.RunningMeans(), jmetrics.RunningMeans()
    for pred, ref in PAIRS:
        row = jmetrics.nlg_metrics(pred, ref)
        assert t.update(row) == j.update(row)
    assert t.n == j.n and t.means() == j.means()

    table = np.random.default_rng(1).standard_normal((512, 16)).astype(np.float32)

    def embed(texts):  # a fixed embedding: one table row per word, 0-padded
        out = np.zeros((len(texts), 24, 16), np.float32)
        for i, text in enumerate(texts):
            for s, w in enumerate(jmetrics.simple_tokenize(text)[:24]):
                out[i, s] = table[sum(map(ord, w)) % 512]
        return out

    preds, refs = zip(*PAIRS)
    got = tmetrics.bert_score(preds, refs, embed)
    want = jmetrics.bert_score(preds, refs, embed)
    for key in ("precision", "recall", "f1"):
        np.testing.assert_array_equal(got[key], want[key])


def test_text_rules_equal_jax():
    tok_t, tok_j = tds.SimpleTokenizer(), jds.SimpleTokenizer()
    text = ". ".join(s for s in _sentences(np.random.default_rng(2)) if s.strip())
    for budget in (8, 20, 40, 400):
        got = tds.truncate_text_sentence_sampling(tok_t, text, budget, random.Random(3))
        want = jds.truncate_text_sentence_sampling(tok_j, text, budget, random.Random(3))
        assert got == want
    for pred, _ in PAIRS:
        assert tds.clean_report_text(pred) == jds.clean_report_text(pred)


# --------------------------------------------------------------- datasets

PROJ = 4


def _write_manifest(root, n_cap=5, n_vqa=4):
    """A caption manifest (one report in a .txt file) and a location-VQA
    manifest, with volumes and slice features as .npy files under `root`."""
    rng = np.random.default_rng(4)
    reports = [p or "Clear." for p, _ in PAIRS[:n_cap]]
    entries = []
    for i in range(max(n_cap, n_vqa)):
        np.save(os.path.join(root, f"vol{i}.npy"),
                rng.random((1, 4, 8, 8)).astype(np.float64))
        np.save(os.path.join(root, f"feat{i}.npy"),
                rng.random((2, 16)).astype(np.float32))
        entries.append({"image": f"vol{i}.npy", "biomedclip_features": f"feat{i}.npy"})
    with open(os.path.join(root, "report0.txt"), "w") as f:
        f.write('The "heart" (cardiac silhouette) is normal. No effusion.')
    caption = [dict(e, text=("report0.txt" if i == 0 else reports[i]))
               for i, e in enumerate(entries[:n_cap])]
    findings = ["nodule", "pleural effusion", "atelectasis", "mass"]
    vqa = [dict(e, abnormality=findings[i % 4], anatomy=ANATOMY_REGIONS[i % 3])
           for i, e in enumerate(entries[:n_vqa])]
    paths = {}
    for name, data in (("caption", caption), ("vqa", vqa)):
        paths[name] = os.path.join(root, f"{name}.json")
        with open(paths[name], "w") as f:
            json.dump({"train": data, "validation": data}, f)
    return paths


def _tokenizer(pkg):
    tok = pkg.SimpleTokenizer(vocab_size=96)
    tok.add_special_tokens({"additional_special_tokens": pkg.SPECIAL_TOKENS})
    return tok


def _datasets(tmp_path, split="validation", val_limit=3):
    paths = _write_manifest(str(tmp_path))
    out = {}
    for pkg in (tds, jds):
        args = pkg.DataArgs(data_root=str(tmp_path), max_length=24,
                            proj_out_num=PROJ, val_limit=val_limit)
        tok = _tokenizer(pkg)
        out[pkg] = (pkg.CaptionDataset(args, tok, paths["caption"], split),
                    pkg.VQALocationDataset(args, tok, paths["vqa"], split),
                    tok)
    return out


@pytest.mark.parametrize("split", ["validation", "train"])
def test_datasets_equal_jax(tmp_path, split):
    sets = _datasets(tmp_path, split)
    t_cap, t_vqa, _ = sets[tds]
    j_cap, j_vqa, _ = sets[jds]
    assert len(t_cap) == len(j_cap) == (3 if split == "validation" else 5)
    assert len(t_vqa) == len(j_vqa) == (3 if split == "validation" else 4)
    for t_set, j_set in ((t_cap, j_cap), (t_vqa, j_vqa)):
        for i in range(len(t_set)):
            got, want = t_set[i], j_set[i]
            assert set(got) == set(want)
            for key, value in want.items():
                if isinstance(value, np.ndarray):
                    assert got[key].dtype == value.dtype
                    np.testing.assert_array_equal(got[key], value)
                else:
                    assert got[key] == value
    assert "heart cardiac silhouette" in t_cap[0]["answer"]  # the .txt, cleaned


# --------------------------------------------------------------- harnesses


def _fixed_generate(tok, max_new=10):
    """Seeded ids over the tokenizer's words (with EOS and pads), one call
    after another the same in both packages."""
    rng = np.random.default_rng(5)

    def ids(b):
        out = rng.integers(4, len(tok._tokens), (b, max_new)).astype(np.int32)
        out[0, 3:] = tok.pad_token_id
        out[-1, 5] = tok.eos_token_id
        return out

    return ids


def _harness_inputs(tmp_path, task):
    sets = _datasets(tmp_path, "train")
    loaders = {}
    for pkg in (tds, jds):
        cap, vqa, tok = sets[pkg]
        ds = cap if task == "mrg" else vqa
        for i in range(len(ds)):  # fill the tokenizers' vocabularies alike
            tok.encode(ds[i]["answer"] + " " + ds[i]["question"])
        loaders[pkg] = (pkg.DataLoader(ds, batch_size=2, shuffle=False,
                                       drop_remainder=False), tok)
    return loaders


@pytest.mark.parametrize("max_samples", [None, 3])
def test_mrg_harness_equals_jax(tmp_path, max_samples):
    loaders = _harness_inputs(tmp_path, "mrg")
    (t_loader, t_tok), (j_loader, j_tok) = loaders[tds], loaders[jds]
    t_ids, j_ids = _fixed_generate(t_tok), _fixed_generate(j_tok)
    seen = []

    def t_gen(input_ids, kv_lens, volume, slices):
        assert isinstance(input_ids, torch.Tensor) and slices is not None
        seen.append(kv_lens.tolist())
        return torch.as_tensor(t_ids(input_ids.shape[0]))

    def j_gen(params, input_ids, kv_lens, volume, slices):
        return jnp.asarray(j_ids(input_ids.shape[0]))

    got = evaluate_mrg(t_gen, t_loader, t_tok, csv_path=str(tmp_path / "t.csv"),
                       max_samples=max_samples, device="cpu")
    want = jax_mrg(j_gen, None, j_loader, j_tok, csv_path=str(tmp_path / "j.csv"),
                   max_samples=max_samples)
    assert got == want
    assert got["num_samples"] == (max_samples or 5)
    assert (tmp_path / "t.csv").read_bytes() == (tmp_path / "j.csv").read_bytes()
    assert all(PROJ < n <= 24 for lens in seen for n in lens)  # valid lengths
    assert got["bleu1"] > 0 and set(CSV_FIELDS) <= set(
        (tmp_path / "t.csv").read_text().splitlines()[0].split(","))


def test_vqa_harness_equals_jax(tmp_path):
    loaders = _harness_inputs(tmp_path, "vqa")
    (t_loader, t_tok), (j_loader, j_tok) = loaders[tds], loaders[jds]
    t_ids, j_ids = _fixed_generate(t_tok), _fixed_generate(j_tok)
    got = evaluate_vqa(
        lambda ids, lens, vol, sl: torch.as_tensor(t_ids(ids.shape[0])),
        t_loader, t_tok, device="cpu")
    want = jax_vqa(
        lambda p, ids, lens, vol, sl: jnp.asarray(j_ids(ids.shape[0])),
        None, j_loader, j_tok)
    assert got == want
    assert "classification_report" in got and len(got["per_anatomy"]) == 3


# ------------------------------------------------------------------ the CLI


@contextlib.contextmanager
def _recording_decode(pkg):
    """Record the id rows each package's tokenizer decodes: the generated
    tokens of a CLI run, row by row."""
    rows = []
    decode = pkg.SimpleTokenizer.decode

    def spy(self, ids, skip_special_tokens=True):
        rows.append(np.asarray(ids).tolist())
        return decode(self, ids, skip_special_tokens=skip_special_tokens)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pkg.SimpleTokenizer, "decode", spy)
        yield rows


def _run(main, argv, pkg, **kw):
    with _recording_decode(pkg) as rows, contextlib.redirect_stdout(io.StringIO()) as out:
        metrics = main(argv, **kw)
    printed = json.loads(out.getvalue())
    return metrics, rows, printed


def _jax_vlm_params():
    """The JAX CLI's params for `--synthetic`: PRNGKey(0) on the first
    synthetic batch (hsenet_tpu/cli/evaluate.py)."""
    cfg = jax_vlm_config(argparse.Namespace(synthetic=True))
    tok = jds.SimpleTokenizer(vocab_size=cfg.llm.vocab_size)
    tok.add_special_tokens({"additional_special_tokens": jds.SPECIAL_TOKENS})
    args = jds.DataArgs(max_length=96, proj_out_num=cfg.num_image_tokens)
    ds = jds.SyntheticCTDataset(n=4, shape=(1, *cfg.vision.image_size),
                                tokenizer=tok, mode="caption", args=args,
                                num_slices=cfg.vision.num_slices,
                                slice_dim=cfg.vision.slice_feature_dim)
    batch = next(iter(jds.DataLoader(ds, batch_size=4, shuffle=False,
                                     drop_remainder=False)))
    model = JaxVLM(cfg, dtype=jnp.float32)
    return jax.jit(model.init)(
        jax.random.PRNGKey(0), jnp.asarray(batch["input_ids"]),
        jnp.asarray(batch["image"]), jnp.asarray(batch["image_2d"]))


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    """The JAX CLI's `--synthetic` runs (mrg with its CSV, vqa) and the
    bridged checkpoint of its weights."""
    root = tmp_path_factory.mktemp("cli")
    ckpt = str(root / "vlm.pt")
    save_params(ckpt, flax_to_torch(jax.tree.map(np.asarray, _jax_vlm_params())))
    mrg = ["--task", "mrg", "--synthetic", "--csv"]
    runs = {
        "mrg": _run(jeval.main, mrg + [str(root / "jax.csv")], jds),
        "vqa": _run(jeval.main, ["--task", "vqa", "--synthetic"], jds),
    }
    return dict(root=root, ckpt=ckpt, runs=runs)


@pytest.mark.parametrize("route", [[], ["--engine"], ["--spec-decode"],
                                   ["--engine", "--spec-decode"]],
                         ids=["greedy", "engine", "spec-decode", "engine-spec"])
def test_cli_mrg_equals_jax(cli_runs, route):
    """mrg through make_greedy_generate, the serving engine and prompt-lookup
    decoding: the JAX CLI's greedy tokens and metrics (its engine and
    speculative routes are lossless greedy too), and its CSV bytes."""
    root = cli_runs["root"]
    csv = str(root / f"port-{'-'.join(route) or 'greedy'}.csv")
    argv = ["--task", "mrg", "--synthetic", "--checkpoint", cli_runs["ckpt"],
            "--csv", csv, *route]
    got, rows, printed = _run(teval.main, argv, tds, device="cpu")
    want, want_rows, want_printed = cli_runs["runs"]["mrg"]
    assert len(rows) == 4 and rows == want_rows
    assert got == want and printed == want_printed
    with open(csv, "rb") as f, open(root / "jax.csv", "rb") as g:
        assert f.read() == g.read()


def test_cli_vqa_equals_jax(cli_runs):
    argv = ["--task", "vqa", "--synthetic", "--checkpoint", cli_runs["ckpt"],
            "--engine", "--engine-vol-cache", "2", "--engine-kv-prefix-cache", "2"]
    got, rows, printed = _run(teval.main, argv, tds, device="cpu")
    want, want_rows, want_printed = cli_runs["runs"]["vqa"]
    assert rows == want_rows and got == want and printed == want_printed


def test_cli_model_keyword_equals_checkpoint(cli_runs):
    """`main(model=...)` evaluates the given model: the bridged one gives the
    --checkpoint run's tokens, and --checkpoint loads into a given model."""
    from hsenet_torch.cli.common import build_vlm_config, restore_checkpoint
    from hsenet_torch.models.mllm import HSENetVLM

    cfg = build_vlm_config(argparse.Namespace(synthetic=True))
    model = HSENetVLM(cfg, dtype=torch.float32, device="cpu").eval()
    restore_checkpoint(model, cli_runs["ckpt"])
    _, rows, _ = _run(teval.main, ["--task", "mrg", "--synthetic", "--kv-int8"],
                      tds, device="cpu", model=model)
    _, want_rows, _ = _run(teval.main, ["--task", "mrg", "--synthetic", "--kv-int8",
                                        "--checkpoint", cli_runs["ckpt"]],
                           tds, device="cpu")
    assert rows == want_rows
    _, fresh_rows, _ = _run(teval.main, ["--task", "mrg", "--synthetic"], tds,
                            device="cpu")
    assert fresh_rows != cli_runs["runs"]["mrg"][1]  # seed-0 weights differ


def test_cli_retrieval_equals_jax(tmp_path):
    """Recall@k of the JAX CLI's PRNGKey(0) CLIP, bridged, equals the
    port's."""
    want, _, _ = _run(jeval.main, ["--task", "retrieval", "--synthetic"], jds)
    cfg = jeval._tiny_clip_cfg()
    ds = jds.SyntheticCTDataset(n=16, shape=(1, *cfg.vision.image_size),
                                tokenizer=jds.SimpleTokenizer(vocab_size=cfg.text.vocab_size),
                                mode="clip", args=jds.DataArgs(max_text_len=16))
    batch = next(iter(jds.DataLoader(ds, batch_size=8, shuffle=False)))
    params = jax.jit(JaxCLIP(cfg).init)(
        jax.random.PRNGKey(0), jnp.asarray(batch["image"]),
        jnp.asarray(batch["input_ids"]), jnp.asarray(batch["attention_mask"]))
    ckpt = str(tmp_path / "clip.pt")
    save_params(ckpt, flax_to_torch(jax.tree.map(np.asarray, params)))
    got, _, printed = _run(teval.main, ["--task", "retrieval", "--synthetic",
                                        "--checkpoint", ckpt], tds, device="cpu")
    assert got == want == printed
    assert set(got) == {f"{d}_r@{k}" for d in ("i2t", "t2i") for k in (1, 5, 10)}


def test_retrieval_needs_synthetic():
    """The JAX CLI reads `cfg.text.vocab_size` with `cfg = None` for
    `--task retrieval` without --synthetic (ROADMAP §C); the port raises a
    clear NotImplementedError there."""
    with pytest.raises(AttributeError, match="'NoneType' object has no attribute 'text'"):
        jeval.main(["--task", "retrieval", "--checkpoint", "x"])
    with pytest.raises(NotImplementedError, match="needs --synthetic"):
        teval.main(["--task", "retrieval", "--checkpoint", "x"], device="cpu")


@pytest.mark.parametrize(
    "flags,error,match",
    # seg and rec are ported: they run and report their metrics
    # (test_torch_seg_vlm.py holds them against the JAX CLI)
    [(["--task", "seg"], None, "dice"),
     (["--task", "rec"], None, "acc@0.5"),
     # sampling is ported; as in the JAX CLI it refuses the engine
     (["--task", "mrg", "--do-sample", "--engine"], AssertionError,
      "--engine eval is greedy-only"),
     # --dp / --tp run over torchrun's ranks (test_torch_parallel_cli.py);
     # in a one-process world they raise the JAX create_mesh's mesh-size
     # error
     (["--task", "vqa", "--dp", "2"], ValueError,
      "mesh 2x1 needs more than 1 devices"),
     (["--task", "mrg", "--tp", "2"], ValueError,
      "mesh 1x2 needs more than 1 devices")],
    ids=["seg", "rec", "do-sample", "dp", "tp"],
)
def test_cli_options_of_later_slices_raise(flags, error, match):
    if error is None:
        with contextlib.redirect_stdout(io.StringIO()):
            assert match in teval.main([*flags, "--synthetic"], device="cpu")
        return
    with pytest.raises(error, match=match):
        teval.main([*flags, "--synthetic"], device="cpu")


def test_cli_refuses_missing_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA; the check is for hosts without it")
    with pytest.raises(RuntimeError, match="CUDA"):
        teval.main(["--task", "mrg", "--synthetic"])
