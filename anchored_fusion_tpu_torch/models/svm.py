"""SVM false-positive filter variant (host code, as in the JAX package).

Parity with ``utils/SVM.py``: 5-dim per-base encodings of the 61-char
junction window (H marked with an all-ones feature block), sklearn SVC with
probability outputs, 5-fold cross-validation keeping the highest-accuracy
fold estimator.  ``SVC(probability=True)`` takes no ``random_state``, so its
Platt scaling draws from NumPy's global RNG: seed that for a repeatable run.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

from anchored_fusion_tpu_torch.models.bilstm import encode_61

_ONE_HOT = {0: [1, 0, 0, 0, 0], 1: [0, 1, 0, 0, 0], 2: [0, 0, 1, 0, 0],
            3: [0, 0, 0, 1, 0], 4: [1, 1, 1, 1, 1]}


def featurize(lines: Sequence[str], width: int = 61) -> np.ndarray:
    toks = encode_61(list(lines), width)
    out = np.zeros((len(toks), width * 5), np.float32)
    for i, row in enumerate(toks):
        for j, t in enumerate(row):
            out[i, j * 5:(j + 1) * 5] = _ONE_HOT[int(t)]
    return out


def train_svm(positives: Sequence[str], negatives: Sequence[str],
              seed: int = 1122) -> Tuple[object, callable]:
    """5-fold CV SVC keeping the best-accuracy fold (utils/SVM.py:179-185);
    needs scikit-learn."""
    from sklearn import svm
    from sklearn.model_selection import cross_validate

    rng = np.random.default_rng(seed)
    X = np.concatenate([featurize(list(positives)), featurize(list(negatives))])
    y = np.concatenate([np.ones(len(positives)), np.zeros(len(negatives))])
    order = rng.permutation(len(y))
    X, y = X[order], y[order]
    model = svm.SVC(probability=True)
    results = cross_validate(model, X, y, cv=5,
                             scoring=["accuracy"], return_estimator=True)
    best = results["estimator"][int(results["test_accuracy"].argmax())]

    def score(lines: Sequence[str]) -> List[float]:
        return best.predict_proba(featurize(list(lines)))[:, 1].tolist()

    return best, score
