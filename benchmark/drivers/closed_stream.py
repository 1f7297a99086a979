"""Listeners in closed loops on `SynthesisEngine.stream_synthesize` with the
text frontend: `clients` threads, each streaming the schedule's next
Mandarin text when its previous stream has ended. The engine's lock lets
one stream run at a time, so streams queue; each stream is timed from the
call until its first chunk is on the host, the wait for the lock included.

The frontend is the port's G2pProsody over its vendored tables, with a
FrontendScorer(FrontendModel) at bert-base-chinese's geometry whose weights
the benchmark draws from the seed.

Traffic keys: `bert` (BertConfig fields that differ from bert-base-chinese's
geometry; none in a benchmark mix), `clients`, `think_s` (a client's pause
between the end of one stream and its next call, as a listener's next
request comes over the network: without it the client whose stream just
ended takes the engine's lock again before a waiting thread wakes),
`clauses` and `hanzi` (distributions of clauses a text and hanzi a
clause), `pool` (texts drawn), `order`, `block` and `pad` (the chunk
schedule), `warm_streams` (texts of a separate draw streamed before the
window; then the decoder runs once at every stack size), `check_streams`
(streams replayed through the reference after the window, the one with
the most chunks always among them).
"""

from __future__ import annotations

import os
import threading
import time

import numpy as np
import torch

from benchmark import ROOT
from benchmark import calls as C
from benchmark import harness, traffic
from benchmark.harness import Tracer, sync
from benchmark.reference import serving as ref_serving
from benchmark.reference.text import bert as ref_bert
from benchmark.reference.text.frontend import G2pProsody as RefG2pProsody
from benchmark.reference.text.g2p_en import G2pEn as RefG2pEn
from benchmark.reference.text.lexicon import Lexicon as RefLexicon
from benchmark.reference.text.lexicon import (
    read_pinyin2phones as ref_pinyin2phones,
)
from benchmark.reference.text.segmenter import sentence_segment
from benchmark.system import (
    build_reference,
    build_system,
    make_weights,
    phone_table,
    sub_seed,
)

ASSETS = os.path.join(ROOT, "wetts_tpu_torch", "assets")
# the engine's clause split length and its largest text bucket
MAX_CLAUSE_LEN, TEXT_CAP, GROUP = 32, 192, 8
N_PROSODY = 5


def lexicon_file(name: str) -> str:
    return os.path.join(ASSETS, "lexicon", name)


def read_list(path: str) -> dict:
    with open(path, encoding="utf8") as f:
        return {line.strip(): i for i, line in enumerate(f)}


def tables():
    """(vocab, polyphone table): [PAD], [CLS], [SEP], [UNK] and the hanzi of
    pinyin_dict.txt (bert-base-chinese's vocab.txt is not in the repo), and
    the polyphone classes of polyphone.txt."""
    lexicon = RefLexicon(lexicon_file("pinyin_dict.txt"))
    vocab = {t: i for i, t in enumerate(
        ["[PAD]", "[CLS]", "[SEP]", "[UNK]"] + list(lexicon.words()))}
    return vocab, read_list(lexicon_file("polyphone.txt")), lexicon


def reference_frontend(scorer, vocab, pinyin2id):
    return RefG2pProsody(
        scorer, vocab, RefLexicon(lexicon_file("pinyin_dict.txt")),
        pinyin2id, ref_pinyin2phones(lexicon_file("lexicon.txt")),
        RefG2pEn(os.path.join(ASSETS, "cmudict_mini.txt")))


def program_frontend(bert_weights, vocab, pinyin2id, device, geometry):
    from wetts_tpu_torch.frontend.scorer import FrontendScorer
    from wetts_tpu_torch.models.bert_frontend import BertConfig, FrontendModel
    from wetts_tpu_torch.text.frontend import G2pProsody
    from wetts_tpu_torch.text.g2p_en import G2pEn
    from wetts_tpu_torch.text.lexicon import Lexicon, read_pinyin2phones

    with torch.device(device):
        bert = FrontendModel(len(pinyin2id), N_PROSODY,
                             BertConfig(**geometry))
    bert.load_state_dict(bert_weights, strict=True)
    return G2pProsody(
        FrontendScorer(bert), vocab, Lexicon(lexicon_file("pinyin_dict.txt")),
        pinyin2id, read_pinyin2phones(lexicon_file("lexicon.txt")),
        G2pEn(os.path.join(ASSETS, "cmudict_mini.txt")))


def reference_bert(pinyin2id, device, geometry, weights=None):
    with torch.device(device):
        model = ref_bert.FrontendModel(
            len(pinyin2id), N_PROSODY, ref_bert.BertConfig(**geometry)).eval()
    if weights is not None:
        model.load_state_dict(weights, strict=True)
    return model


@torch.no_grad()
def warm_stacks(engine, mix, device) -> None:
    """The decoder at every stack of chunks a stream can decode: 1 to
    STREAM_TAIL_MAX rows of block + 2 * pad frames."""
    from wetts_tpu_torch.serving.engine import STREAM_TAIL_MAX

    model = engine.model
    frames = mix["block"] + 2 * mix["pad"]
    channels = model.dec.conv_pre.weight.shape[1]
    gen = torch.Generator(device=device).manual_seed(0)
    for rows in range(1, STREAM_TAIL_MAX + 1):
        z = torch.randn((rows, frames, channels), generator=gen,
                        device=device)
        model.decode(z, sid=torch.zeros(rows, dtype=torch.long,
                                        device=device))


def setup(run) -> dict:
    cfg, mix = run.cfg, run.mix
    vocab, pinyin2id, lexicon = tables()
    ref = reference_bert(pinyin2id, run.device, mix["bert"])
    bert_weights = make_weights(
        {k: v.shape for k, v in ref.state_dict().items()}, run.seed,
        run.device, stream=7)
    del ref
    frontend = program_frontend(bert_weights, vocab, pinyin2id, run.device,
                                mix["bert"])
    weights, engine, run.record["length_scale"] = build_system(
        cfg, run.seed, run.device, frontend=frontend)
    hanzi = [w for w in lexicon.words() if len(w) == 1]
    rng = np.random.default_rng(sub_seed(run.seed, 2))
    texts = traffic.text_requests(mix, rng, hanzi)
    speakers = rng.integers(0, cfg["num_speakers"], len(texts))
    warm_rng = np.random.default_rng(sub_seed(run.seed, 3))
    for text in traffic.text_requests(dict(mix, pool=mix["warm_streams"]),
                                      warm_rng, hanzi):
        for _ in engine.stream_synthesize(text, "spk0", mix["block"],
                                          mix["pad"]):
            pass
    warm_stacks(engine, mix, run.device)
    sync(run.device)
    tracer = Tracer(run.trace)
    state = {"engine": engine, "weights": weights, "tracer": tracer,
             "bert_weights": bert_weights, "vocab": vocab,
             "pinyin2id": pinyin2id, "texts": texts,
             "speakers": [int(s) for s in speakers]}
    run.record["decoder_shapes"] = []
    C.record_decoder_shapes(engine, tracer, run.record["decoder_shapes"])
    return state


def drive(run, state, seconds: float, record: bool):
    """The clients' closed loops for `seconds`, each stream timed and, with
    `record`, its phone ids (as the engine's frontend gave them, clause by
    clause), its chunks and its generator states kept. Returns the
    streams and the first errors."""
    engine, tracer, mix = state["engine"], state["tracer"], run.mix
    texts, speakers = state["texts"], state["speakers"]
    local = threading.local()
    to_ids = engine.text_to_phone_ids
    generator = engine.generator

    def recorded_ids(text):
        ids = to_ids(text)
        rec = getattr(local, "rec", None)
        if rec is not None:
            if rec["state"] is None:  # the stream holds the lock: no draw yet
                rec["state"] = generator.get_state()
            rec["ids"].append(list(ids))
        return ids

    if record:
        engine.text_to_phone_ids = recorded_ids
    streams, next_k = [], [0]
    pick = threading.Lock()
    errors = []

    def client():
        while True:
            with pick:
                if time.perf_counter() - t0 >= seconds:
                    return
                k = next_k[0]
                next_k[0] += 1
                rec = {"k": k, "ids": [], "state": None, "chunks": []}
                streams.append(rec)
            local.rec = rec
            rec["t_call"] = time.perf_counter()
            try:
                j = k % len(texts)
                it = engine.stream_synthesize(texts[j], f"spk{speakers[j]}",
                                              mix["block"], mix["pad"])
                while True:
                    with tracer.span("stream_next"):
                        chunk = next(it, None)
                    if chunk is None:
                        break
                    if not rec["chunks"]:
                        rec["t_first"] = time.perf_counter()
                    if record:
                        rec["chunks"].append(chunk)
                        # the generator holds the engine lock while
                        # suspended
                        rec["state_after"] = generator.get_state()
            except Exception as e:  # noqa: BLE001 - a failed stream
                rec["error"] = repr(e)
                errors.append(rec["error"])
            local.rec = None
            time.sleep(mix["think_s"])

    threads = [threading.Thread(target=client, daemon=True)
               for _ in range(mix["clients"])]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    engine.text_to_phone_ids = to_ids
    return streams, errors


def failed(streams) -> int:
    return sum(1 for r in streams if "t_first" not in r or "error" in r)


def window(run, state) -> None:
    engine = state["engine"]
    engine.stage_times.reset()
    streams, errors = drive(run, state, run.seconds, record=True)
    run.window_s = run.seconds
    run.record.update(
        streams=streams, attempted=len(streams), failed=failed(streams),
        first_chunk_ms=[1e3 * (r["t_first"] - r["t_call"])
                        if "t_first" in r and "error" not in r
                        else float("inf") for r in streams],
        stage_times=engine.stage_times.report(), errors=errors[:3])


def trace(run, state) -> None:
    """The same clients, TRACE_SLICE_S under the profiler; a stream that
    fails there fails the run too."""
    tracer = state["tracer"]
    tracer.start()
    streams, _ = drive(run, state, harness.TRACE_SLICE_S, record=False)
    tracer.stop()
    run.trace_data = tracer.data()
    run.record["failed"] += failed(streams)


def reference_ids(frontend, phones: dict, text: str):
    """The frontend's ids of each clause: normalized, converted, mapped
    with a `sil` head (unknown phones skipped); a clause with no phones
    gives no ids."""
    out = []
    for sentence in sentence_segment(text, MAX_CLAUSE_LEN) or [text]:
        ph = frontend.compute(frontend.normalize(sentence))
        out.append(([phones["sil"]] + [phones[p] for p in ph
                                       if p in phones]) if ph else [])
    return out


def synthesized_ids(clause_ids):
    """What the engine synthesizes of a stream's clause ids: clauses with
    no ids dropped, each cut to the largest text bucket."""
    return [ids[:TEXT_CAP] for ids in clause_ids if ids]


def check(run, state, control: bool = False):
    """The window's sampled streams against the reference: each clause's
    phone ids, and each chunk; with `control`, the reference under TF32
    (frontend and synthesis) in the program's place."""
    streams = [r for r in run.record["streams"] if "error" not in r]
    rng = np.random.default_rng(sub_seed(run.seed, 4))
    picked = []
    if streams:
        longest = max(range(len(streams)),
                      key=lambda k: len(streams[k]["chunks"]))
        rest = [k for k in range(len(streams)) if k != longest]
        take = rng.choice(len(rest), size=min(run.mix["check_streams"] - 1,
                                              len(rest)), replace=False)
        picked = sorted([longest] + [rest[int(k)] for k in take])
    weights, bert_weights = state["weights"], state["bert_weights"]
    vocab, pinyin2id = state["vocab"], state["pinyin2id"]
    texts, speakers = state["texts"], state["speakers"]
    C.free_program(state)
    state.pop("engine", None)
    model = build_reference(run.cfg, run.device, weights)
    frontend = reference_frontend(
        ref_bert.Scorer(reference_bert(pinyin2id, run.device,
                                       run.mix["bert"], bert_weights)),
        vocab, pinyin2id)
    phones = phone_table()
    ids_mismatch = len_mismatch = draw_mismatch = chunks = 0
    worst = 0.0

    def reference_stream(rec):
        k = rec["k"] % len(texts)
        clause_ids = reference_ids(frontend, phones, texts[k])
        ids = synthesized_ids(clause_ids)
        gen = torch.Generator(device=run.device)
        gen.set_state(rec["state"])
        chunks = []
        for lo in range(0, len(ids), GROUP):
            chunks += ref_serving.stream_chunks(
                model, ids[lo: lo + GROUP], speakers[k], C.scales(run),
                gen, run.device, run.mix["block"], run.mix["pad"])
        return clause_ids, chunks, gen.get_state()

    for k in picked:
        rec = streams[k]
        ids, want, after = reference_stream(rec)
        if control:
            with C.tf32():
                got_ids, got, _ = reference_stream(rec)
        else:
            got_ids, got = rec["ids"], rec["chunks"]
        if ids != got_ids:
            ids_mismatch += 1
        if not torch.equal(after, rec["state_after"]):
            draw_mismatch += 1
        if len(got) != len(want):
            len_mismatch += 1
            continue
        for g, w in zip(got, want):
            chunks += 1
            if g.shape != w.shape:
                len_mismatch += 1
                continue
            if g.size:
                worst = max(worst, float(np.max(np.abs(g - w))))
    first = sorted(run.record["first_chunk_ms"])
    return {"streams_compared": len(picked), "chunks_compared": chunks,
            "first_chunk_p50_ms": first[len(first) // 2] if first else None,
            "first_chunk_max_ms": first[-1] if first else None,
            "ids_mismatch": ids_mismatch, "len_mismatch": len_mismatch,
            "draw_mismatch": draw_mismatch, "audio_max_abs": worst}
