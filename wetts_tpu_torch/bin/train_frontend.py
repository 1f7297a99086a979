"""Frontend (prosody + polyphone BERT) training entry (port of
wetts_tpu/bin/train_frontend.py; the reference's wetts/frontend/train.py
CLI): polyphone and prosody supervision files and dicts, frozen local BERT
weights, joint-CE training with per-epoch CV
(examples/chinese_prosody_polyphone/run.sh:14-55).

    python -m wetts_tpu_torch.bin.train_frontend --model_dir exp/frontend \\
        --vocab bert-base-chinese/vocab.txt --bert_dir bert-base-chinese \\
        --polyphone_file train_polyphone.txt --polyphone_dict polyphone.txt \\
        --prosody_file train_prosody.txt

Writes `config.json` (the JAX package's keys) and, after each epoch,
`params.npz` in the flax layout and a `metrics.jsonl` line. Runs on the GPU
and raises without one; `--device cpu` asks for the CPU.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os


def get_args(argv=None):
    p = argparse.ArgumentParser(description="train BERT frontend "
                                            "(PyTorch/CUDA)")
    p.add_argument("--model_dir", required=True)
    p.add_argument("--vocab", required=True, help="BERT vocab.txt")
    p.add_argument("--polyphone_file", default=None)
    p.add_argument("--polyphone_dict", default=None,
                   help="polyphone list file (one pron per line)")
    p.add_argument("--prosody_file", default=None)
    p.add_argument("--num_prosody", type=int, default=5)
    p.add_argument("--cv_polyphone_file", default=None)
    p.add_argument("--cv_prosody_file", default=None)
    p.add_argument("--bert_dir", default=None,
                   help="local HF BERT dir (config.json + pytorch_model.bin)")
    p.add_argument("--lr", type=float, default=5e-5)
    p.add_argument("--epochs", type=int, default=10)
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--phone_weight", type=float, default=0.5)
    p.add_argument("--max_steps", type=int, default=None)
    p.add_argument("--tiny", action="store_true",
                   help="random tiny BERT (smoke testing without weights)")
    p.add_argument("--device", default=None,
                   help="cuda (default; raises without a GPU) or cpu")
    return p.parse_args(argv)


def load_bert(bert_dir, vocab_size, tiny):
    """(BertConfig, the HF BertModel state_dict or None) of a local HF BERT
    directory; a random tiny BERT without one or under `tiny`."""
    import torch

    from wetts_tpu_torch.models.bert_frontend import BertConfig

    if tiny or bert_dir is None:
        return BertConfig.tiny(vocab_size), None
    with open(os.path.join(bert_dir, "config.json")) as f:
        hf = json.load(f)
    cfg = BertConfig(
        vocab_size=hf["vocab_size"],
        hidden_size=hf["hidden_size"],
        num_layers=hf["num_hidden_layers"],
        num_heads=hf["num_attention_heads"],
        intermediate_size=hf["intermediate_size"],
        max_position=hf["max_position_embeddings"],
        type_vocab_size=hf.get("type_vocab_size", 2))
    for name in ("pytorch_model.bin", "model.safetensors"):
        path = os.path.join(bert_dir, name)
        if os.path.exists(path):
            if name.endswith(".bin"):
                sd = torch.load(path, map_location="cpu", weights_only=True)
            else:
                from safetensors.torch import load_file

                sd = load_file(path)
            return cfg, {k[len("bert."):] if k.startswith("bert.") else k: v
                         for k, v in sd.items()}
    return cfg, None


def build_model(bert_cfg, num_polyphones: int, num_prosody: int,
                bert_state=None):
    """The FrontendModel of the JAX CLI's geometry (transform heads and FFN
    from BERT's width), its parameters drawn after torch.manual_seed(42)
    (the JAX trainer's seed), BERT's from `bert_state` where given.
    Returns (model, the config.json dict)."""
    import torch

    from wetts_tpu_torch.models.bert_frontend import FrontendModel

    heads, ffn = (8, 2048) if bert_cfg.hidden_size >= 768 else (
        max(2, bert_cfg.hidden_size // 26), 4 * bert_cfg.hidden_size)
    torch.manual_seed(42)
    model = FrontendModel(num_polyphones, num_prosody, bert_cfg, heads, ffn)
    if bert_state is not None:
        own = model.bert.state_dict()
        missing = sorted(set(own) - set(bert_state))
        if missing:
            raise KeyError(f"BERT tensors missing: {missing[:10]}")
        model.bert.load_state_dict({k: bert_state[k] for k in own})
    return model, {
        "bert": dataclasses.asdict(bert_cfg),
        "num_polyphones": num_polyphones, "num_prosody": num_prosody,
        "transform_heads": heads, "transform_ffn": ffn,
    }


def read_polyphone_dict(path):
    if not path:
        return None
    with open(path, encoding="utf8") as f:
        return {line.strip(): i for i, line in enumerate(f) if line.strip()}


def main(argv=None):
    args = get_args(argv)
    from wetts_tpu_torch.frontend.dataset import (
        CharTokenizer,
        FrontendDataset,
    )
    from wetts_tpu_torch.frontend.train import FrontendTrainer
    from wetts_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    tokenizer = CharTokenizer(args.vocab)
    poly_dict = read_polyphone_dict(args.polyphone_dict)
    prosody_dict = {f"#{i}": i for i in range(args.num_prosody)}

    train_ds = FrontendDataset(tokenizer, args.polyphone_file, poly_dict,
                               args.prosody_file, prosody_dict)
    cv_ds = None
    if args.cv_polyphone_file or args.cv_prosody_file:
        cv_ds = FrontendDataset(tokenizer, args.cv_polyphone_file, poly_dict,
                                args.cv_prosody_file, prosody_dict)

    bert_cfg, bert_state = load_bert(args.bert_dir, len(tokenizer.vocab),
                                     args.tiny)
    model, mc = build_model(bert_cfg, len(poly_dict) if poly_dict else 1,
                            args.num_prosody, bert_state)
    os.makedirs(args.model_dir, exist_ok=True)
    with open(os.path.join(args.model_dir, "config.json"), "w") as f:
        json.dump(mc, f, indent=2)

    trainer = FrontendTrainer(
        model, train_ds, cv_ds, args.model_dir, lr=args.lr,
        epochs=args.epochs, batch_size=args.batch_size,
        phone_weight=args.phone_weight, device=device)
    metrics = trainer.train(max_steps=args.max_steps)
    print(json.dumps(metrics))


if __name__ == "__main__":
    main()
