"""Full-state checkpoints with resume, and the G and R exports.

Port of scrabblegan_tpu/train/checkpoint.py. Orbax is not on the card's
machine, so the format is the port's own:
- a checkpoint is <ckpt_dir>/<step>/state.pt, a `torch.save` of plain
  tensors, ints and lists: the four networks' parameters and statistics
  (their state_dicts), the four optimizer states (their counts as 0-d
  tensors), the step and G's EMA. It is
  written into a temporary directory, flushed to disk and moved into place
  with `os.replace`, so a reader sees a whole checkpoint or none; the newest
  MAX_TO_KEEP are kept, as Orbax's `max_to_keep=3`;
- an export is <model_dir>/{generator,recognizer}/<n>/variables.npz, the
  network's flax {"params", "batch_stats"} tree (`convert.save_flax_npz`),
  with the run's config.json beside it, so `infer --model-dir` needs nothing
  else. The train CLI numbers its exports by the step they were taken at.
"""

from __future__ import annotations

import os
import shutil
import tempfile
from collections.abc import Mapping

import torch

from scrabblegan_torch.config import Config, save_config
from scrabblegan_torch.convert import load_flax_npz, save_flax_npz
from scrabblegan_torch.train.state import TrainState

STATE_FILE = "state.pt"
EXPORT_FILE = "variables.npz"
MAX_TO_KEEP = 3


def _numbered(root: str, filename: str) -> list[int]:
    """The numbers n of the complete <root>/<n>/<filename>, ascending."""
    if not os.path.isdir(root):
        return []
    return sorted(int(d) for d in os.listdir(root)
                  if d.isdigit() and os.path.isfile(os.path.join(root, d, filename)))


def _publish(tmp: str, final: str) -> None:
    """Move the finished directory `tmp` to `final`, replacing an older one."""
    if os.path.isdir(final):
        shutil.rmtree(final)
    os.replace(tmp, final)


def save_state(ckpt_dir: str, state: TrainState, step: int) -> str:
    """Write the full train state as checkpoint `step`; returns its directory."""
    os.makedirs(ckpt_dir, exist_ok=True)
    payload = {
        "step": state.step,
        "models": {net: module.state_dict() for net, module in state.modules().items()},
        "opt_states": {net: {"count": s.count, "nu": s.nu, "mu": s.mu}
                       for net, s in state.opt_states.items()},
        "g_ema": state.g_ema,
    }
    tmp = tempfile.mkdtemp(prefix=f".{step}.", dir=ckpt_dir)
    with open(os.path.join(tmp, STATE_FILE), "wb") as f:
        torch.save(payload, f)
        f.flush()
        os.fsync(f.fileno())
    final = os.path.join(ckpt_dir, str(step))
    _publish(tmp, final)
    for old in _numbered(ckpt_dir, STATE_FILE)[:-MAX_TO_KEEP]:
        shutil.rmtree(os.path.join(ckpt_dir, str(old)))
    return final


def latest_step(ckpt_dir: str) -> int | None:
    """The step of the newest complete checkpoint, or None."""
    steps = _numbered(ckpt_dir, STATE_FILE)
    return steps[-1] if steps else None


def _restore_list(saved: list[torch.Tensor] | None, into: list[torch.Tensor] | None,
                  what: str) -> None:
    """Copy a saved list of tensors into the state's, in place."""
    if (saved is None) != (into is None) or (saved is not None and len(saved) != len(into)):
        raise ValueError(f"checkpoint {what} does not match the state's (was it written "
                         "with another config?)")
    if saved is None:
        return
    for s, t in zip(saved, into):
        if s.shape != t.shape or s.dtype != t.dtype:
            raise ValueError(f"checkpoint {what}: {tuple(s.shape)} {s.dtype} where the "
                             f"state holds {tuple(t.shape)} {t.dtype}")
    with torch.no_grad():
        for s, t in zip(saved, into):
            t.copy_(s)


def restore_state(ckpt_dir: str, template: TrainState) -> tuple[TrainState | None, int]:
    """Load the newest checkpoint into `template`; returns (template, step),
    or (None, 0) when there is no checkpoint. Every tensor of the state,
    the optimizers' counts included, is written in place, so that CUDA
    graphs captured on the template stay valid. Raises when the
    checkpoint's layout differs from the template's, as a restore into
    another config's state would."""
    step = latest_step(ckpt_dir)
    if step is None:
        return None, 0
    payload = torch.load(os.path.join(ckpt_dir, str(step), STATE_FILE), map_location="cpu",
                         weights_only=True)
    for net, module in template.modules().items():
        module.load_state_dict(payload["models"][net], strict=True)
    for net, tmpl in template.opt_states.items():
        saved = payload["opt_states"][net]
        _restore_list(saved["nu"], tmpl.nu, f"{net} second moment")
        _restore_list(saved["mu"], tmpl.mu, f"{net} first moment")
        tmpl.count.copy_(torch.as_tensor(saved["count"]))  # an int before the counts moved
    _restore_list(payload["g_ema"], template.g_ema, "G EMA")
    template.step = int(payload["step"])
    template.step_t.fill_(template.step)
    return template, step


def _save_net(model_dir: str, name: str, variables: Mapping, n: int, cfg: Config) -> str:
    root = os.path.join(model_dir, name)
    os.makedirs(root, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix=f".{n}.", dir=root)
    save_flax_npz(os.path.join(tmp, EXPORT_FILE), variables)
    save_config(cfg, os.path.join(tmp, "config.json"))
    final = os.path.join(root, str(n))
    _publish(tmp, final)
    return final


def save_generator(model_dir: str, variables: Mapping, n: int, cfg: Config) -> str:
    """G's flax tree as export <model_dir>/generator/<n>/ with its config."""
    return _save_net(model_dir, "generator", variables, n, cfg)


def save_recognizer(model_dir: str, variables: Mapping, n: int, cfg: Config) -> str:
    """R's flax tree as export <model_dir>/recognizer/<n>/ with its config."""
    return _save_net(model_dir, "recognizer", variables, n, cfg)


def load_export(path: str) -> dict:
    """The flax tree of an export directory (G's or R's)."""
    return load_flax_npz(os.path.join(path, EXPORT_FILE))


def _latest_export(model_dir: str, name: str) -> str | None:
    numbers = _numbered(os.path.join(model_dir, name), EXPORT_FILE)
    return os.path.join(model_dir, name, str(numbers[-1])) if numbers else None


def latest_generator_export(model_dir: str) -> str | None:
    return _latest_export(model_dir, "generator")


def latest_recognizer_export(model_dir: str) -> str | None:
    return _latest_export(model_dir, "recognizer")
