"""The per-epoch export gate.

The port of scrabblegan_tpu/eval/gate.py (numpy and os): every G export is
scored with the calibrated deterministic metric rfid_rand
(`fid.random_features`; threshold 6 separated broken from readable exports
at 100% recall and 0% false alarm over 50 scored exports,
docs/quality/rfid_rand_calibration.json) as
excess = rfid(gen, real_a) - rfid(real_b, real_a), the real-vs-real floor
taken at the same sample count; `annotate_export` writes
quality_<epoch>.json beside the exports and keeps the `latest_good`
symlink on the newest 'ok' epoch, which `latest_good_export` finds.
"""

from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np

from scrabblegan_torch.eval.fid import compute_rfid, random_features

# docs/quality/rfid_rand_calibration.json: 100% recall / 0% false alarm
DEFAULT_THRESHOLD = 6.0


def score_export(gen_images: np.ndarray, real_images: np.ndarray,
                 threshold: float = DEFAULT_THRESHOLD,
                 extractor=None) -> dict:
    """Score generated images against real ones with the calibrated
    deterministic extractor.

    real_images must hold at least 2x as many samples as gen_images uses for
    its half: it is split into two disjoint halves — one compared against the
    generated batch, the other providing the same-sample-count real-vs-real
    floor. Returns a JSON-serializable dict with the raw score, floor,
    bias-corrected excess, and the 'ok' / 'suspect' flag."""
    extractor = extractor or random_features()
    n = len(real_images) // 2
    real_a, real_b = real_images[:n], real_images[n:2 * n]
    score = compute_rfid(np.asarray(gen_images), real_a, extractor)
    floor = compute_rfid(real_b, real_a, extractor)
    excess = score - floor
    return {
        "metric": "rfid_rand",
        "rfid_rand": round(float(score), 4),
        "real_floor": round(float(floor), 4),
        "excess": round(float(excess), 4),
        "threshold": threshold,
        "n_gen": int(len(gen_images)),
        "n_real_half": int(n),
        "flag": "suspect" if excess > threshold else "ok",
    }


def annotate_export(model_dir: str, epoch: int, result: dict) -> str:
    """Write quality_<epoch>.json next to the export and refresh the
    `latest_good` symlink to the newest 'ok' epoch.

    The flag file lives beside the export directories (model_dir/generator/),
    where the JAX package keeps it."""
    root = os.path.join(model_dir, "generator")
    os.makedirs(root, exist_ok=True)
    path = os.path.join(root, f"quality_{epoch}.json")
    with open(path, "w") as f:
        json.dump(result, f, indent=2)
        f.write("\n")
    if result.get("flag") == "ok":
        link = os.path.join(root, "latest_good")
        tmp = link + ".tmp"
        if os.path.islink(tmp) or os.path.exists(tmp):
            os.remove(tmp)
        os.symlink(str(epoch), tmp)  # relative: survives dir moves
        os.replace(tmp, link)
    return path


def latest_good_export(model_dir: str) -> Optional[str]:
    """Newest export whose gate flag was 'ok' (the latest_good symlink),
    or None when no gated export exists."""
    link = os.path.join(model_dir, "generator", "latest_good")
    if os.path.islink(link) and os.path.isdir(link):
        return os.path.realpath(link)
    return None
