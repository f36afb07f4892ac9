"""The EEG downstream (TSTR) evaluation: bandpass -> CSP -> LDA
(``vgd_tpu/eval/eeg_downstream.py``; numpy + scipy, no sklearn).

* Butterworth bandpass 8-30 Hz, order 5, at fs = 250 / 4;
* two-class CSP: the generalised eigenproblem C1 w = l (C1 + C0) w on
  trace-normalised mean class covariances, the 4 filters with the largest
  |l - 0.5|, log relative variance features;
* two-class LDA with sklearn's default ``solver="svd"``, in numpy: class
  means, priors from the class frequencies, the within-class data scaled
  per feature and by 1 / sqrt(n - n_classes) (the pooled within-class
  scatter over n - n_classes), its SVD cut at rank tolerance 1e-4, then the
  between-class SVD cut at 1e-4 of its largest value; a sample is class 1
  when ``x @ coef + intercept > 0``. The ``eigen`` / ``lsqr`` solvers'
  biased per-class covariances are a different function (the log-prior
  term moves the boundary by another amount), so they are not it;
* accuracy, F1 of class 1 and Cohen's kappa, as sklearn's scores;
* the four training regimes of the TSTR table (``cli._tstr``): synthetic
  only, real only, synthetic + real, other subject;
* the welch PSD of the C3 / Cz / C4 average.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
from scipy.signal import butter, lfilter, welch

from vgd_tpu_torch.data.eeg import DOWNSAMPLING, FS

FS_DEC = FS / DOWNSAMPLING
#: sklearn's ``LinearDiscriminantAnalysis(tol=1e-4)``: singular values of
#: the scaled within-class data at or below it are rank-deficient
LDA_TOL = 1e-4


def bandpass_filter(data: np.ndarray, lowcut: float = 8.0,
                    highcut: float = 30.0, fs: float = FS_DEC,
                    order: int = 5) -> np.ndarray:
    """Butterworth bandpass along the last axis."""
    b, a = butter(order, [lowcut, highcut], fs=fs, btype="band")
    return lfilter(b, a, data)


class CSP:
    """Common spatial patterns for two classes (fit: the generalised
    eigenproblem; transform: log of each filter's share of the variance)."""

    def __init__(self, n_components: int = 4):
        self.n_components = n_components
        self.filters_: Optional[np.ndarray] = None

    @staticmethod
    def _class_cov(trials: np.ndarray) -> np.ndarray:
        covs = []
        for t in trials:
            c = t @ t.T
            tr = np.trace(c)
            if not np.isfinite(tr) or tr <= 0:
                continue  # degenerate or non-finite trial
            covs.append(c / tr)
        if not covs:
            raise ValueError("no finite trials for CSP covariance")
        return np.mean(covs, axis=0)

    def fit(self, X: np.ndarray, y: np.ndarray) -> "CSP":
        from scipy.linalg import eigh
        classes = np.unique(y)
        if len(classes) != 2:
            raise ValueError(f"CSP here is two-class, got {len(classes)}")
        c1 = self._class_cov(X[y == classes[1]])
        c0 = self._class_cov(X[y == classes[0]])
        evals, evecs = eigh(c1, c1 + c0)
        order = np.argsort(np.abs(evals - 0.5))[::-1]
        self.filters_ = evecs[:, order[:self.n_components]].T
        return self

    def transform(self, X: np.ndarray) -> np.ndarray:
        Z = np.einsum("fc,nct->nft", self.filters_, X)
        var = Z.var(axis=2)
        var = var / var.sum(axis=1, keepdims=True)
        return np.log(np.maximum(var, 1e-12))

    def fit_transform(self, X, y):
        return self.fit(X, y).transform(X)


class LDA:
    """Two-class linear discriminant analysis, sklearn's ``svd`` solver
    (module docstring)."""

    def __init__(self, tol: float = LDA_TOL):
        self.tol = tol

    def fit(self, X: np.ndarray, y: np.ndarray) -> "LDA":
        from scipy.linalg import svd
        X = np.asarray(X, np.float64)
        self.classes_, inv, counts = np.unique(y, return_inverse=True,
                                               return_counts=True)
        n, n_classes = X.shape[0], len(self.classes_)
        if n_classes != 2:
            raise ValueError(f"two classes expected, got {n_classes}")
        if n <= n_classes:
            raise ValueError("more samples than classes needed")
        priors = counts.astype(np.float64) / float(n)
        means = np.zeros((n_classes, X.shape[1]))
        np.add.at(means, inv, X)
        means /= counts[:, None]
        xc = np.concatenate([X[y == c] - means[i]
                             for i, c in enumerate(self.classes_)])
        xbar = priors @ means
        std = np.std(xc, axis=0)
        std[std == 0] = 1.0
        # within-class scaling: the pooled scatter over n - n_classes
        _, s, vt = svd(np.sqrt(1.0 / (n - n_classes)) * (xc / std),
                       full_matrices=False)
        rank = int(np.sum(s > self.tol))
        scalings = (vt[:rank] / std).T / s[:rank]
        # between-class scaling of the weighted centres
        centres = (np.sqrt(n * priors / (n_classes - 1))
                   * (means - xbar).T).T @ scalings
        _, s, vt = svd(centres, full_matrices=False)
        rank = int(np.sum(s > self.tol * s[0]))
        scalings = scalings @ vt.T[:, :rank]
        coef = (means - xbar) @ scalings
        intercept = -0.5 * np.sum(coef ** 2, axis=1) + np.log(priors)
        coef = coef @ scalings.T
        intercept -= xbar @ coef.T
        self.coef_ = coef[1] - coef[0]
        self.intercept_ = intercept[1] - intercept[0]
        return self

    def decision_function(self, X: np.ndarray) -> np.ndarray:
        return np.asarray(X, np.float64) @ self.coef_ + self.intercept_

    def predict(self, X: np.ndarray) -> np.ndarray:
        return self.classes_[(self.decision_function(X) > 0).astype(int)]


def classification_scores(y_true, y_pred) -> Dict[str, float]:
    """Accuracy, F1 of class 1 (0 when it is never predicted nor true) and
    Cohen's kappa (NaN where it is undefined), as sklearn computes them."""
    y_true, y_pred = np.asarray(y_true), np.asarray(y_pred)
    tp = float(np.sum((y_pred == 1) & (y_true == 1)))
    fp = float(np.sum((y_pred == 1) & (y_true != 1)))
    fn = float(np.sum((y_pred != 1) & (y_true == 1)))
    f1 = 2 * tp / (2 * tp + fp + fn) if (2 * tp + fp + fn) > 0 else 0.0
    labels = np.unique(np.concatenate([y_true, y_pred]))
    ti, pi = np.searchsorted(labels, y_true), np.searchsorted(labels, y_pred)
    cm = np.zeros((len(labels), len(labels)))
    np.add.at(cm, (ti, pi), 1.0)
    sum0, sum1 = cm.sum(axis=0), cm.sum(axis=1)
    expected = np.outer(sum0, sum1) / np.sum(sum0)
    w = 1.0 - np.eye(len(labels))
    denom = np.sum(w * expected)
    kappa = float(1 - np.sum(w * cm) / denom) if denom != 0 else float("nan")
    return {"acc": float(np.mean(y_true == y_pred)), "f1": float(f1),
            "k": kappa}


def tstr_evaluate(X_train: np.ndarray, y_train: np.ndarray,
                  X_test: np.ndarray, y_test: np.ndarray
                  ) -> Tuple[Dict[str, float], Dict[str, float]]:
    """Train on X, test on real: bandpass both sets, fit CSP + LDA on the
    training set, return its (train, test) scores. X: (N, C, T); y: 1 =
    motor imagery, 0 = baseline."""
    X_train = bandpass_filter(np.asarray(X_train, np.float64))
    X_test = bandpass_filter(np.asarray(X_test, np.float64))
    csp, lda = CSP(), LDA()
    F_train = csp.fit_transform(X_train, y_train)
    lda.fit(F_train, y_train)
    train_scores = classification_scores(y_train, lda.predict(F_train))
    test_scores = classification_scores(y_test,
                                        lda.predict(csp.transform(X_test)))
    return train_scores, test_scores


def mean_central_psd(trials: np.ndarray, nperseg: int = 64
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """(frequencies, mean PSD) of the C3 / Cz / C4 average channel (welch,
    ``nperseg`` 64 at fs = 250 / 4)."""
    surrogate = (trials[:, 7, :] + trials[:, 9, :] + trials[:, 11, :]) / 3
    psds = []
    for s in surrogate:
        fx, psd = welch(s, fs=FS_DEC, nperseg=nperseg)
        psds.append(psd)
    return fx, np.mean(psds, axis=0)
