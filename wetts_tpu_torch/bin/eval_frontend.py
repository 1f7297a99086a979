"""Frontend evaluation entry: polyphone accuracy and prosody PW/PPH/IPH F1
(port of wetts_tpu/bin/eval_frontend.py; reference
wetts/frontend/test_polyphone.py and test_prosody.py:56-103).

    python -m wetts_tpu_torch.bin.eval_frontend --model_dir exp/frontend \\
        --vocab vocab.txt --polyphone_file test_polyphone.txt \\
        --polyphone_dict polyphone.txt --prosody_file test_prosody.txt

Reads a `config.json` + `params.npz` dir (a `bin/train_frontend` run or
an exported bundle of either package) and prints one JSON object. Runs on
the GPU and raises without one; `--device cpu` asks for the CPU.
"""

from __future__ import annotations

import argparse
import json


def get_args(argv=None):
    p = argparse.ArgumentParser(description="eval BERT frontend")
    p.add_argument("--model_dir", required=True)
    p.add_argument("--vocab", required=True)
    p.add_argument("--polyphone_file", default=None)
    p.add_argument("--polyphone_dict", default=None)
    p.add_argument("--prosody_file", default=None)
    p.add_argument("--num_prosody", type=int, default=5)
    p.add_argument("--exclude_sentence_end", action="store_true")
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--device", default=None,
                   help="cuda (default; raises without a GPU) or cpu")
    return p.parse_args(argv)


def evaluate(model, ds, batch_size: int, exclude_sentence_end: bool,
             device) -> dict:
    """Polyphone accuracy and prosody F1 of `model` over `ds`."""
    import torch

    from wetts_tpu_torch.frontend.dataset import IGNORE_ID
    from wetts_tpu_torch.frontend.eval import prosody_f1

    poly_correct = poly_total = 0
    ref_ranks, hyp_ranks = [], []
    for ids, mask, poly, pros in ds.batches(batch_size, shuffle=False):
        with torch.no_grad():
            phone_logits, prosody_logits = model(
                torch.from_numpy(ids).to(device),
                torch.from_numpy(mask).to(device))
        phone_pred = phone_logits.argmax(-1).cpu().numpy()
        prosody_pred = prosody_logits.argmax(-1).cpu().numpy()
        valid_p = poly != IGNORE_ID
        poly_correct += int((phone_pred[valid_p] == poly[valid_p]).sum())
        poly_total += int(valid_p.sum())
        for b in range(ids.shape[0]):
            sel = pros[b] != IGNORE_ID
            if sel.any():
                ref_ranks.append(pros[b][sel].tolist())
                hyp_ranks.append(prosody_pred[b][sel].tolist())
    out = {}
    if poly_total:
        out["polyphone_accuracy"] = poly_correct / poly_total
    if ref_ranks:
        out.update(prosody_f1(ref_ranks, hyp_ranks, exclude_sentence_end))
    return out


def main(argv=None):
    args = get_args(argv)
    from wetts_tpu_torch.bin.train_frontend import read_polyphone_dict
    from wetts_tpu_torch.cli.model import load_frontend_model
    from wetts_tpu_torch.frontend.dataset import (
        CharTokenizer,
        FrontendDataset,
    )
    from wetts_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    model = load_frontend_model(args.model_dir).to(device)
    prosody_dict = {f"#{i}": i for i in range(args.num_prosody)}
    ds = FrontendDataset(CharTokenizer(args.vocab), args.polyphone_file,
                         read_polyphone_dict(args.polyphone_dict),
                         args.prosody_file, prosody_dict)
    out = evaluate(model, ds, args.batch_size, args.exclude_sentence_end,
                   device)
    print(json.dumps(out, indent=2))


if __name__ == "__main__":
    main()
