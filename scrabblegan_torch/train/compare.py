"""How two train steps from one start are held to each other's gradients:
the rule shared by the whole-step tests (port vs JAX on the CPU) and by
chip_smoke.py (kernel vs plain cores, card vs CPU).

Adam's first update is +-lr whatever the gradient's size, so the new
parameters alone would hide a wrong gradient. At the first update lean
Adam's second moment is nu = (1 - b2) g^2, so |g| = sqrt(nu / (1 - b2)) is
read from it, and compared leaf by leaf in the Frobenius norm, relative to
max(the leaf's norm, FLOOR x the network's largest leaf norm), so that a
leaf whose gradient cancels to noise (a conv bias before a batch norm) is
held to the network's scale. The update's sign is then compared wherever
|g| exceeds both a tenth of its leaf's largest and the leaf's error bound:
no error within the bound can flip those."""

from __future__ import annotations

import numpy as np

FLOOR = 1e-2


def abs_grads(nu: list, beta_2: float) -> list[np.ndarray]:
    """|g| in float64 from the second moments of a first Adam update."""
    return [np.sqrt(np.asarray(v, np.float64) / (1 - beta_2)) for v in nu]


def gradient_errors(got: list, want: list, floor: float = FLOOR
                    ) -> tuple[list[float], list[float]]:
    """Per leaf of two parallel lists of |g| arrays: the error
    |got - want|_F / scale, and the scale max(|want|_F, floor x the largest
    leaf norm of `want`)."""
    norms = [float(np.linalg.norm(w)) for w in want]
    largest = max(norms)
    scales = [max(n, floor * largest) for n in norms]
    errors = [float(np.linalg.norm(np.asarray(g) - w)) / s
              for g, w, s in zip(got, want, scales)]
    return errors, scales


def sign_mask(want: np.ndarray, bound: float) -> np.ndarray:
    """The elements of one leaf whose |g| exceeds both a tenth of the leaf's
    largest and `bound` (rtol x the leaf's scale): their update's sign must
    agree."""
    return want > max(0.1 * want.max(initial=0.0), bound)
