"""VITS training entry (port of wetts_tpu/bin/train_vits.py; the reference's
CLI, wetts/vits/utils/task.py:172-237): JSON config + manifests + phone and
speaker tables.

Usage:
    python -m wetts_tpu_torch.bin.train_vits -c config.json -m exp/v1 \
        --train_data data/train.txt --val_data data/val.txt \
        --phone_table data/phones.txt --speaker_table data/speaker.txt \
        [--slm_model wavlm_dir]

`--slm_model` names a local HuggingFace WavLM directory (`config.json` and
`pytorch_model.bin` or `model.safetensors`) for the WavLM discriminator of
a config with `model.use_wd`; bf16 compute is the config's
`train.bf16_run` (or `fp16_run`). Runs on the GPU and raises without one;
`--device cpu` asks for the CPU.

Data parallelism, one process per GPU (`parallel/mesh.py`): under torchrun,
    torchrun --nproc_per_node 8 -m wetts_tpu_torch.bin.train_vits \
        --multihost -c config.json -m exp/v1 ...
reads RANK / WORLD_SIZE / LOCAL_RANK / MASTER_ADDR / MASTER_PORT; without
it, start each process with `--multihost --coordinator host:port
--num_processes N --process_id i`. NCCL on the GPUs, gloo with `--device
cpu`. `train.batch_size` is per process, as in the reference's DDP.
"""

from __future__ import annotations

import argparse
import os
import shutil


def get_args(argv=None):
    p = argparse.ArgumentParser(description="train VITS (PyTorch/CUDA)")
    p.add_argument("-c", "--config", required=True)
    p.add_argument("-m", "--model_dir", required=True)
    p.add_argument("--train_data", required=True)
    p.add_argument("--val_data", default=None)
    p.add_argument("--phone_table", required=True)
    p.add_argument("--speaker_table", default=None)
    p.add_argument("--max_steps", type=int, default=None)
    p.add_argument("--slm_model", default=None,
                   help="local HF WavLM dir for the SLM discriminator")
    p.add_argument("--num_workers", type=int, default=0,
                   help="accepted for reference-CLI compatibility")
    p.add_argument("--device", default=None,
                   help="cuda (default; raises without a GPU) or cpu")
    p.add_argument("--multihost", action="store_true",
                   help="join a torch.distributed process group (torchrun's "
                        "environment, or the three flags below)")
    p.add_argument("--coordinator", default=None,
                   help="rank 0's host:port (multihost)")
    p.add_argument("--num_processes", type=int, default=None)
    p.add_argument("--process_id", type=int, default=None)
    return p.parse_args(argv)


def main(argv=None):
    args = get_args(argv)

    from wetts_tpu_torch.config import Config
    from wetts_tpu_torch.parallel.mesh import (
        host_shard_info,
        init_distributed,
    )
    from wetts_tpu_torch.train.trainer import Trainer

    device = args.device
    if args.multihost:
        device = init_distributed(args.coordinator, args.num_processes,
                                  args.process_id, device)

    cfg = Config.from_json(args.config)
    os.makedirs(args.model_dir, exist_ok=True)
    # copy config into the run dir for reproducibility (task.py:211-216)
    if host_shard_info()[0] == 0:
        shutil.copyfile(args.config,
                        os.path.join(args.model_dir, "config.json"))
    trainer = Trainer(cfg, args.model_dir, args.train_data,
                      args.phone_table, args.speaker_table, args.val_data,
                      device=device, slm_model_dir=args.slm_model)
    step = trainer.train(max_steps=args.max_steps)
    if args.multihost:
        print(f"rank {trainer.rank} of {trainer.world}: step {step}, "
              f"parameters sha1 {trainer.parameter_digest()}", flush=True)
        import torch.distributed as dist

        dist.destroy_process_group()


if __name__ == "__main__":
    main()
