"""The frontend's trainer and tools in the port (`frontend/{dataset, eval,
train}.py`, `bin/{train, eval, export}_frontend.py`) against the JAX
package's, on the CPU, at a tiny BERT (`BertConfig.tiny`).

- The datasets give the same batches and the metrics the same values.
- Three `FrontendTrainer` updates from the JAX trainer's init (carried over
  by `frontend_params_from_jax`), with a prosody-only batch among them,
  equal the JAX trainer's parameters within 1e-5, and BERT's weights,
  which only optax's weight decay moves, take the JAX trainer's steps.
  Adam's eps is 1e-2 on both sides, as in tests/test_dp_equivalence.py:
  at 1e-8 a parameter whose gradient is zero in exact arithmetic (the
  transform layer's key bias) moves by +-lr on rounding noise.
- A `params.npz` written by either trainer is read by the other package.
- `export_frontend --verify` (f32 and bf16) passes, and both packages read
  the bundle.
"""

from __future__ import annotations

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from wetts_tpu.frontend import dataset as jdataset
from wetts_tpu.frontend import eval as jeval
from wetts_tpu.frontend import train as jtrain
from wetts_tpu.models import bert_frontend as jbert
from wetts_tpu.utils.params_io import load_params_npz as jax_load_npz
from wetts_tpu_torch.bin import eval_frontend, export_frontend, train_frontend
from wetts_tpu_torch.cli.model import load_frontend_model
from wetts_tpu_torch.frontend import dataset, eval as peval, train
from wetts_tpu_torch.models.bert_frontend import BertConfig
from wetts_tpu_torch.utils.convert import frontend_params_from_jax

CHARS = "宋代出现了燕乐今天气怎么样我们去北京上海"
POLYPHONE = ["宋代出现了▁le5▁燕乐", "今天去了▁le5▁北京"]
PROSODY = ["今天 #1 天气 #1 怎么样 #3", "我们 #1 去 #2 北京 #4",
           "宋代 #2 出现 #1 燕乐 #3", "上海 #1 天气 #4",
           "今天 #2 我们 #1 去 #1 上海 #4", "北京 #1 天气 #1 怎么样 #3",
           "燕乐 #2 出现 #4"]
LR, BATCH, STEPS = 0.1, 3, 3


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    d = tmp_path_factory.mktemp("frontend_corpus")
    (d / "vocab.txt").write_text("\n".join(
        ["[PAD]", "[CLS]", "[SEP]", "[UNK]"] + list(dict.fromkeys(CHARS))),
        encoding="utf8")
    (d / "poly.txt").write_text("\n".join(POLYPHONE) + "\n", encoding="utf8")
    (d / "pros.txt").write_text("\n".join(PROSODY) + "\n", encoding="utf8")
    (d / "polyphone_dict.txt").write_text("le5\nliao3\n", encoding="utf8")
    return d


def datasets(corpus, mod):
    tok = mod.CharTokenizer(str(corpus / "vocab.txt"))
    return tok, mod.FrontendDataset(
        tok, str(corpus / "poly.txt"), {"le5": 0, "liao3": 1},
        str(corpus / "pros.txt"), {f"#{i}": i for i in range(5)})


def test_dataset_batches_equal_the_jax_ones(corpus):
    (jtok, jds), (tok, ds) = datasets(corpus, jdataset), datasets(corpus,
                                                                  dataset)
    assert tok.vocab == jtok.vocab and len(ds) == len(jds) == 9
    for epoch in range(3):
        for shuffle in (True, False):
            want = list(jds.batches(BATCH, epoch, shuffle=shuffle))
            got = list(ds.batches(BATCH, epoch, shuffle=shuffle))
            assert len(got) == len(want)
            for g, w in zip(got, want):
                for a, b in zip(g, w):
                    np.testing.assert_array_equal(a, b)


def test_eval_metrics_equal_the_jax_ones():
    rng = np.random.default_rng(0)
    ref = [rng.integers(0, 5, int(n)).tolist()
           for n in rng.integers(2, 12, 20)]
    hyp = [[(r + int(rng.integers(0, 2))) % 5 for r in row] for row in ref]
    for exclude in (False, True):
        assert peval.prosody_f1(ref, hyp, exclude) == jeval.prosody_f1(
            ref, hyp, exclude)
    a, b = rng.integers(0, 3, 50), rng.integers(0, 3, 50)
    assert peval.polyphone_accuracy(a, b) == jeval.polyphone_accuracy(a, b)


def test_masked_ce_of_an_empty_label_set_is_zero():
    logits = torch.randn(2, 5, 3)
    labels = torch.full((2, 5), dataset.IGNORE_ID)
    loss, correct, n = train.masked_ce_and_acc(logits, labels)
    assert float(loss) == 0.0 and int(correct) == 0 and int(n) == 0
    jloss, jc, jn = jtrain.masked_ce_and_acc(jnp.asarray(logits.numpy()),
                                             jnp.asarray(labels.numpy()))
    assert float(jloss) == 0.0 and int(jc) == int(jn) == 0


@pytest.mark.parametrize("total,warmup", [(30, 3), (7, 0), (10, 1)])
def test_schedule_equals_optax(total, warmup):
    sched = optax.warmup_cosine_decay_schedule(0.0, LR, warmup, total, 0.0)
    for step in range(total + 3):
        assert train.warmup_cosine(step, LR, warmup, total) == \
            pytest.approx(float(sched(step)), rel=1e-5, abs=1e-9)  # f32


def port_model(jparams, bert_cfg: BertConfig):
    """The port's model at the JAX CLI's geometry with the JAX params."""
    model, _ = train_frontend.build_model(bert_cfg, 2, 5)
    model.load_state_dict(frontend_params_from_jax(
        jparams, {"bert": bert_cfg}))
    return model


@pytest.fixture(scope="module")
def trained(corpus, tmp_path_factory, monkeypatch_module):
    """The JAX and the port trainer, three updates each from one init."""
    monkeypatch_module.setattr(jtrain.optax, "adamw",
                               functools.partial(optax.adamw, eps=1e-2))
    monkeypatch_module.setattr(train, "EPS", 1e-2)
    jtok, jds = datasets(corpus, jdataset)
    _, ds = datasets(corpus, dataset)
    jcfg = jbert.BertConfig.tiny(len(jtok.vocab))
    bert_cfg = BertConfig.tiny(len(jtok.vocab))
    heads, ffn = max(2, 32 // 26), 4 * 32
    jmodel = jbert.FrontendModel(2, 5, jcfg, heads, ffn)
    jdir = tmp_path_factory.mktemp("jax_trainer")
    jt = jtrain.FrontendTrainer(jmodel, jds, None, str(jdir), lr=LR,
                                batch_size=BATCH)
    init = jax.tree.map(np.asarray, jt.params)
    model = port_model(init, bert_cfg)
    pdir = tmp_path_factory.mktemp("port_trainer")
    pt = train.FrontendTrainer(model, ds, None, str(pdir), lr=LR,
                               batch_size=BATCH, device="cpu")
    jm = jt.train(max_steps=STEPS)
    pm = pt.train(max_steps=STEPS)
    return {"init": init, "jax": (jt, jm, jdir), "port": (pt, pm, pdir),
            "jmodel": jmodel, "bert_cfg": bert_cfg, "geometry": (heads, ffn)}


@pytest.fixture(scope="module")
def monkeypatch_module():
    mp = pytest.MonkeyPatch()
    yield mp
    mp.undo()


def flat(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from flat(tree[k], prefix + (k,))
    else:
        yield prefix, np.asarray(tree)


def test_three_updates_equal_the_jax_trainer(trained, corpus):
    jt, jm, _ = trained["jax"]
    pt, pm, _ = trained["port"]
    # a prosody-only batch is among the three: its polyphone loss is 0
    _, ds = datasets(corpus, dataset)
    batches = list(ds.batches(BATCH, 0))[:STEPS]
    assert any((b[2] == dataset.IGNORE_ID).all() for b in batches)
    assert pt.step == STEPS
    for k in jm:
        assert pm[k] == pytest.approx(jm[k], rel=1e-5, abs=1e-6), k
    got = dict(flat(pt.params()))
    want = dict(flat(jax.tree.map(np.asarray, jt.params)))
    init = dict(flat(trained["init"]))
    assert set(got) == set(want)
    worst = max((float(np.abs(got[k] - want[k]).max()), k) for k in want)
    assert worst[0] < 1e-5, worst
    heads = [k for k in want if k[0] != "bert"]
    assert max(float(np.abs(want[k] - init[k]).max()) for k in heads) > 1e-2
    # BERT moves by the decay alone: the same relative steps on both sides
    for k in (k for k in want if k[0] == "bert"):
        jd, pd = want[k] - init[k], got[k] - init[k]
        scale = float(np.abs(jd).max())
        assert (scale > 0) == bool(init[k].any()), k
        assert float(np.abs(pd - jd).max()) <= 2e-2 * scale, k


def test_params_npz_crosses_both_ways(trained):
    """The port trainer's params.npz read by the JAX package and applied by
    the JAX model; the JAX trainer's read by the port's loader."""
    jmodel = trained["jmodel"]
    _, _, pdir = trained["port"]
    jt, _, jdir = trained["jax"]
    ids = np.array([[1, 5, 6, 7, 8, 2]])
    mask = np.ones_like(ids)
    pt = trained["port"][0]
    with torch.no_grad():
        want = [t.numpy() for t in pt.model(torch.from_numpy(ids),
                                            torch.from_numpy(mask))]
    got = jmodel.apply({"params": jax.tree.map(
        jnp.asarray, jax_load_npz(str(pdir / "params.npz")))}, ids, mask)
    for g, w in zip(got, want):
        np.testing.assert_allclose(np.asarray(g), w, atol=1e-5)

    heads, ffn = trained["geometry"]
    (jdir / "config.json").write_text(json.dumps({
        "bert": trained["bert_cfg"].__dict__, "num_polyphones": 2,
        "num_prosody": 5, "transform_heads": heads, "transform_ffn": ffn}))
    model = load_frontend_model(str(jdir))
    with torch.no_grad():
        got = [t.numpy() for t in model(torch.from_numpy(ids),
                                        torch.from_numpy(mask))]
    want = jmodel.apply({"params": jt.params}, ids, mask)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, np.asarray(w), atol=1e-5)


@pytest.mark.parametrize("bf16", [False, True])
def test_cli_train_eval_export_verify(corpus, tmp_path, bf16, capsys):
    exp = tmp_path / "exp"
    train_frontend.main([
        "--model_dir", str(exp), "--vocab", str(corpus / "vocab.txt"),
        "--polyphone_file", str(corpus / "poly.txt"),
        "--polyphone_dict", str(corpus / "polyphone_dict.txt"),
        "--prosody_file", str(corpus / "pros.txt"), "--tiny",
        "--batch_size", "4", "--max_steps", "2", "--device", "cpu"])
    last = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert all(np.isfinite(v) for v in last.values())
    eval_frontend.main([
        "--model_dir", str(exp), "--vocab", str(corpus / "vocab.txt"),
        "--polyphone_file", str(corpus / "poly.txt"),
        "--polyphone_dict", str(corpus / "polyphone_dict.txt"),
        "--prosody_file", str(corpus / "pros.txt"), "--device", "cpu"])
    metrics = json.loads(capsys.readouterr().out)
    assert 0.0 <= metrics["polyphone_accuracy"] <= 1.0 and "PW" in metrics

    out = tmp_path / "bundle"
    args = ["--model_dir", str(exp), "--vocab", str(corpus / "vocab.txt"),
            "--out_dir", str(out), "--verify", "--device", "cpu"]
    export_frontend.main(args + (["--bf16"] if bf16 else []))
    said = capsys.readouterr().out
    assert "verify: min cosine similarity" in said
    cos = float(said.split("=")[1].split()[0])
    assert cos > (0.95 if bf16 else 0.9999)
    # both packages read the bundle
    from wetts_tpu_torch.utils.params_io import load_params_npz

    load_frontend_model(str(out))
    pparams = dict(flat(load_params_npz(str(out / "params.npz"))))
    for k, v in flat(jax_load_npz(str(out / "params.npz"))):
        np.testing.assert_array_equal(v, pparams[k])
    if bf16:
        with np.load(out / "params.npz") as z:
            assert all(k.startswith("__bf16__") for k in z.files)

