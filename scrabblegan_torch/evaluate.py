"""Quality evaluation entry point of the port: rFID (the Fréchet distance
over recognizer features) between generated and real word images, and the
recognizer's CER on both, per word-length bucket.

Port of evaluate.py:

    python -m scrabblegan_torch.evaluate --workdir W [--device cuda]
        [--bucket B | all | B1,B2] [--num-samples 256]
        [--read-dir D --style-dir S --words-file F] [--config C] [--set K=V]

It restores the newest full checkpoint under <workdir>/checkpoints (the
config found at the workdir unless --config), loads the data set
(<workdir>/synthetic_data when present and no --read-dir is given), draws
real batches from the bucket, generates as many images with EMA weights and
standing statistics (as the Trainer's exports serve), and prints one JSON
line a bucket: {"rfid", "cer_real", "cer_gen", "bucket", "num_samples"}.
Known divergence: with z_source='noise' z comes from a torch.Generator
(seeded with the chunk's index) where JAX uses jax.random.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

from scrabblegan_torch.config import discover_config, load_config
from scrabblegan_torch.data.loaders import sample_fake_labels
from scrabblegan_torch.eval.decode import character_error_rate, greedy_ctc_decode
from scrabblegan_torch.eval.fid import compute_rfid, recognizer_features
from scrabblegan_torch.train.loop import Trainer


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="rFID and CER of a train run of the PyTorch port.")
    p.add_argument("--workdir", required=True)
    p.add_argument("--device", default="cuda")
    p.add_argument("--read-dir", default=None, help="bucketed data set dir")
    p.add_argument("--style-dir", default=None)
    p.add_argument("--words-file", default=None)
    p.add_argument("--num-samples", type=int, default=256)
    p.add_argument("--bucket", default=None,
                   help="word-length bucket, 'all' (every nonempty one, a JSON line each) "
                        "or a comma list (default: the most populated)")
    p.add_argument("--config", default=None)
    p.add_argument("--set", action="append", default=[], metavar="KEY=VALUE")
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    cfg_path = args.config or discover_config(args.workdir, max_up=0)
    if cfg_path and not args.config:
        print(f"using discovered config: {cfg_path}", file=sys.stderr)
    cfg = load_config(cfg_path, dict(kv.split("=", 1) for kv in args.set))

    trainer = Trainer(cfg, workdir=args.workdir, verbose=False, device=args.device)
    default_root = os.path.join(args.workdir, "synthetic_data")
    if args.read_dir is None and os.path.isdir(default_root):
        trainer.load_data(read_dir=os.path.join(default_root, "words-Reading"),
                          style_dir=os.path.join(default_root, "style_imgs"),
                          words_file=os.path.join(default_root, "random_words.txt"))
    else:
        trainer.load_data(read_dir=args.read_dir, style_dir=args.style_dir,
                          words_file=args.words_file)
    state = trainer.init_state(resume=True)
    if state.step == 0:
        print(json.dumps({"error": "no checkpoint found in workdir"}))
        return 1

    ds = trainer.dataset
    b = trainer.batches
    if args.bucket == "all":
        buckets = sorted(ds.nonempty)
    elif args.bucket:
        buckets = [int(k) for k in str(args.bucket).split(",")]
    else:
        buckets = [max(ds.nonempty, key=lambda k: len(ds.labels[k]))]
    n = args.num_samples
    bsz = cfg.shared.batch_size
    np_rng = np.random.default_rng(cfg.seed + 42)

    serve_stats = trainer.standing_stats(state)
    R = state.models.recognizer
    extractor = recognizer_features(R)

    def cer_of(imgs, want_rows, bucket):
        R.eval()
        try:
            with torch.inference_mode():
                logits = np.concatenate([
                    R(torch.from_numpy(imgs[i:i + bsz]).permute(0, 3, 1, 2).to(trainer.device)
                      ).cpu().numpy() for i in range(0, len(imgs), bsz)])
        finally:
            R.train()
        preds = greedy_ctc_decode(logits, np.full((len(imgs),), 4 * bucket - 1, np.int32))
        return character_error_rate(preds, want_rows)

    for bucket in buckets:
        real_imgs, real_labels, gen_imgs, gen_labels = [], [], [], []
        while sum(len(x) for x in real_imgs) < n:
            imgs, labels, _ = ds.sample_batch(bsz, bucket=bucket)
            real_imgs.append(imgs)
            real_labels.append(labels)
            fake = sample_fake_labels(np_rng, b.random_words, bsz, bucket)
            style_idx = np_rng.integers(0, len(b.style_train), size=bsz)
            style = np.stack([b.style_train[i] for i in style_idx])[..., None]
            z = torch.randn((bsz, cfg.shared.latent_dim),
                            generator=torch.Generator().manual_seed(len(gen_imgs))).numpy()
            gen_imgs.append(trainer.generate(state, fake, style_imgs=style.astype(np.float32),
                                             z=z, stats=serve_stats))
            gen_labels.append(fake)

        real_imgs = np.ascontiguousarray(np.concatenate(real_imgs)[:n], np.float32)
        gen_imgs = np.ascontiguousarray(np.concatenate(gen_imgs)[:n], np.float32)
        real_labels = np.concatenate(real_labels)[:n]
        gen_labels = np.concatenate(gen_labels)[:n]

        rfid = compute_rfid(gen_imgs, real_imgs, extractor, batch_size=bsz)
        cer = cer_of(real_imgs, [list(row) for row in real_labels], bucket)
        cer_gen = cer_of(gen_imgs, [list(map(int, row)) for row in gen_labels], bucket)
        print(json.dumps({"rfid": round(rfid, 4), "cer_real": round(cer, 4),
                          "cer_gen": round(cer_gen, 4), "bucket": int(bucket),
                          "num_samples": int(n)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
