"""Dataset converters: raw handwriting datasets -> the bucketed "GAN-Reading"
on-disk format.

Port of scrabblegan_tpu/data/iam.py, on the port's own PNG reader, writer and
resize (`data/images.py`): walk the IAM `words/` tree, parse the `words.txt`
ground truth (skip '#' comments; keep only segmentation-'ok' lines), keep
purely alphabetic transcriptions of length <= bucket_size, resize each word
image to (16*len, 32), 16 px a character at 32 px height, with cv2's
INTER_AREA, and write `<img>.png` + `<img>.txt` pairs into per-length bucket
directories `1/..10/`. A RIMES-style handler (flat image tree and a
transcription file) sits beside the IAM one in `DATASET_HANDLERS`.

The JAX package resizes the uint8 image through cv2's fixed-point uint8
path; here the image is resized in float32 (cv2's float path) and rounded
to the nearest grey level, which can differ from cv2's uint8 result by one
level. Raw files must be PNG.
"""

from __future__ import annotations

import os
from collections import Counter
from typing import Callable, Dict, Iterable, Tuple

import numpy as np

from scrabblegan_torch.data.images import read_grayscale, resize, write_grayscale


def parse_iam_words_txt(words_txt_path: str) -> Dict[str, str]:
    """Parse IAM's words.txt into {<image basename>.png: transcription}; words whose
    segmentation flag is not 'ok' are marked '-1'."""
    transcriptions: Dict[str, str] = {}
    with open(words_txt_path, "r", encoding="utf8") as f:
        for line in f:
            if line.startswith("#"):
                continue
            fields = line.split()
            if len(fields) < 2:
                continue
            file_nm = fields[0] + ".png"
            if fields[1] == "ok":
                transcriptions[file_nm] = fields[-1].strip()
            else:
                transcriptions[file_nm] = "-1"
    return transcriptions


def _walk_pngs(input_dir: str) -> Iterable[str]:
    for dirpath, _dirnames, filenames in os.walk(input_dir):
        for fn in filenames:
            if fn.endswith(".png"):
                yield os.path.join(dirpath, fn)


def convert_to_gan_format(
    input_dir: str,
    output_dir: str,
    target_size: Tuple[int, int, int],
    bucket_size: int,
    transcriptions: Dict[str, str],
    verbose: bool = True,
) -> Tuple[int, Counter]:
    """Generic converter: any {basename: transcription} mapping + an image tree."""
    h, _w, _c = target_size
    valid_samples = 0
    lengths: Counter = Counter()

    for i in range(bucket_size):
        os.makedirs(os.path.join(output_dir, str(i + 1)), exist_ok=True)

    for path in _walk_pngs(input_dir):
        img_nm = os.path.basename(path)
        transcription = transcriptions.get(img_nm)
        if not transcription or not transcription.isalpha():
            continue
        len_word = len(transcription)
        if len_word > bucket_size:
            continue
        img = read_grayscale(path)
        if img is None:
            if verbose:
                print(f"error at: {path}")
            continue
        try:
            resized = np.rint(resize(img.astype(np.float32), (h // 2) * len_word, h,
                                     quality="area"))
        except Exception:
            if verbose:
                print(f"error at: {path}")
            continue
        bucket_dir = os.path.join(output_dir, str(len_word))
        write_grayscale(os.path.join(bucket_dir, img_nm), resized)
        stem = os.path.splitext(img_nm)[0]
        with open(os.path.join(bucket_dir, stem + ".txt"), "w", encoding="utf8") as f:
            f.write(transcription)
        valid_samples += 1
        lengths[len_word] += 1

    if verbose:
        print(f"size of valid words: {valid_samples}")
        print(lengths)
    return valid_samples, lengths


def init_reading(
    raw_dir: str,
    read_dir: str,
    input_dim: Tuple[int, int, int],
    bucket_size: int,
    words_txt: str | None = None,
) -> Tuple[int, Counter]:
    """One-time offline conversion of raw IAM words into `read_dir`.

    `words_txt` defaults to <raw_dir>/../gt/words.txt, then <raw_dir>/words.txt.
    """
    if words_txt is None:
        candidates = [
            os.path.join(os.path.dirname(raw_dir.rstrip("/")), "gt", "words.txt"),
            os.path.join(raw_dir, "words.txt"),
        ]
        words_txt = next((c for c in candidates if os.path.exists(c)), candidates[0])
    print("convert words dataset to GAN-Reading format...")
    transcriptions = parse_iam_words_txt(words_txt)
    print(f"size of dataset words: {len(transcriptions)}")
    return convert_to_gan_format(raw_dir, read_dir, input_dim, bucket_size, transcriptions)


def parse_rimes_groundtruth(gt_path: str) -> Dict[str, str]:
    """Parse a RIMES-style ground-truth file into {<image basename>: word}.

    RIMES word ground truth (e.g. groundtruth_training_icdar2011.txt) is one
    `<relative image path> <transcription>` pair per line. Non-alphabetic
    transcriptions are kept here and filtered by the generic converter, the
    same split of duties as the IAM path."""
    transcriptions: Dict[str, str] = {}
    with open(gt_path, "r", encoding="utf8") as f:
        for line in f:
            fields = line.split(None, 1)
            if len(fields) != 2:
                continue
            rel_path, word = fields[0], fields[1].strip()
            img_nm = os.path.basename(rel_path)
            if not img_nm.endswith(".png"):
                img_nm = os.path.splitext(img_nm)[0] + ".png"
            transcriptions[img_nm] = word
    return transcriptions


def init_reading_rimes(
    raw_dir: str,
    read_dir: str,
    input_dim: Tuple[int, int, int],
    bucket_size: int,
    ground_truth: str | None = None,
) -> Tuple[int, Counter]:
    """RIMES words -> GAN-Reading format.

    `ground_truth` defaults to <raw_dir>/ground_truth.txt, else the first
    .txt file directly under raw_dir."""
    if ground_truth is None:
        default = os.path.join(raw_dir, "ground_truth.txt")
        if os.path.exists(default):
            ground_truth = default
        else:
            txts = sorted(fn for fn in os.listdir(raw_dir)
                          if fn.endswith(".txt"))
            if not txts:
                raise FileNotFoundError(
                    f"no RIMES ground-truth .txt found under {raw_dir}")
            ground_truth = os.path.join(raw_dir, txts[0])
    print("convert RIMES words dataset to GAN-Reading format...")
    transcriptions = parse_rimes_groundtruth(ground_truth)
    print(f"size of dataset words: {len(transcriptions)}")
    return convert_to_gan_format(raw_dir, read_dir, input_dim, bucket_size,
                                 transcriptions)


DATASET_HANDLERS: Dict[str, Callable] = {
    "iam": init_reading,
    "rimes": init_reading_rimes,
}


def register_dataset(name: str, handler: Callable) -> None:
    """Register an additional dataset handler."""
    DATASET_HANDLERS[name] = handler
