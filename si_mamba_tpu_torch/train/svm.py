"""The linear SVM probe of pretraining, on the device: the counterpart of
``evaluate_svm`` in ``si_mamba_tpu/train/runner_pretrain.py``, which fits
sklearn's ``SVC(C=0.01, kernel="linear")`` on the host.

What that call computes is libsvm's C-SVC: one binary problem for every pair
of classes (one-vs-one), each the dual

    min_a 1/2 a^T Q a - e^T a,  0 <= a_i <= C,  y^T a = 0,  Q_ij = y_i y_j x_i . x_j,

with its own bias, and a prediction by votes over the pairs, a tie going to
the lower class. Here every pair's problem is solved at once, batched on the
device in float64: libsvm's SMO with its second-order working-set selection
(WSS2) and its two-variable update, without shrinking, to libsvm's stopping
rule (the largest KKT violation below ``tol``, 1e-3); the bias is libsvm's
(the mean of y_i G_i over the free variables, else the midpoint of its
bounds). Pairs are padded to the largest pair's size; a padded row is never
selected. The one Gram matrix of all the features is kept (n^2 doubles); an
iteration gathers from it the two rows of Q that each pair's update reads,
so a pair's own (n_pair, n_pair) matrix is never built. The problems stop
together when the last one meets the rule, each one frozen from the
iteration it met it on. libsvm stops at the same
tolerance from its own iterates (it also shrinks), so the decision values
agree to about the tolerance, not bitwise.
"""

from __future__ import annotations

import numpy as np
import torch

TAU = 1e-12  # libsvm's floor for a non-positive curvature
MAX_ITER = 100_000  # SMO iterations before a fit gives up
CHECK_EVERY = 16  # iterations between the host's reads of the stopping rule


def _pairs(labels: torch.Tensor, n_classes: int):
    """(pair classes (P, 2), member rows (P, n_max) padded with 0, valid
    (P, n_max), y (P, n_max) +1 for the first class, -1 for the second,
    0 on padding), laid out on the host from the labels."""
    lab = labels.cpu().numpy()
    idx = [np.flatnonzero(lab == c) for c in range(n_classes)]
    pairs = [(a, b) for a in range(n_classes) for b in range(a + 1, n_classes)]
    n_max = max(len(idx[a]) + len(idx[b]) for a, b in pairs)
    rows = np.zeros((len(pairs), n_max), np.int64)
    y = np.zeros((len(pairs), n_max))
    for p, (a, b) in enumerate(pairs):
        na, nb = len(idx[a]), len(idx[b])
        rows[p, :na + nb] = np.concatenate([idx[a], idx[b]])
        y[p, :na], y[p, na:na + nb] = 1.0, -1.0
    dev = labels.device
    y = torch.from_numpy(y).to(dev)
    return torch.tensor(pairs, device=dev), torch.from_numpy(rows).to(dev), y != 0, y


def _last_argmax(t: torch.Tensor) -> torch.Tensor:
    """The last index of each row's largest entry (libsvm's ``>=`` scans)."""
    return t.shape[1] - 1 - torch.argmax(t.flip(1), dim=1)


def fit_ovo(x: torch.Tensor, labels: torch.Tensor, C: float = 0.01, tol: float = 1e-3) -> dict:
    """Fit the one-vs-one linear C-SVC of every pair of the classes present
    in ``labels`` (n,) on features x (n, d), on x's device. Returns
    {"classes" (n_classes,) the sorted labels, "pairs" (P, 2) indices into
    them, "w" (P, d), "rho" (P,), "iterations"}: pair p's decision value at z
    is w_p . z - rho_p, positive for its first class."""
    x = x.double()
    classes, labels = torch.unique(labels.to(x.device).long(), sorted=True,
                                   return_inverse=True)
    pairs, rows, valid, y = _pairs(labels, len(classes))
    P, n = rows.shape
    K = x @ x.T
    QD = torch.diagonal(K)[rows]  # (P, n)
    ar = torch.arange(P, device=x.device)

    def q_row(t: torch.Tensor) -> torch.Tensor:
        """Row t (P,) of every pair's Q: y_t y_s K[rows_t, rows_s], (P, n)."""
        return (y[ar, t][:, None] * y) * K[rows[ar, t][:, None], rows]

    alpha = torch.zeros((P, n), dtype=torch.float64, device=x.device)
    G = torch.where(valid, -1.0, 0.0).double()
    done = torch.zeros(P, dtype=torch.bool, device=x.device)
    neg = torch.tensor(-torch.inf, dtype=torch.float64, device=x.device)
    it = 0
    while it < MAX_ITER:
        up = valid & (((y > 0) & (alpha < C)) | ((y < 0) & (alpha > 0)))
        low = valid & (((y > 0) & (alpha > 0)) | ((y < 0) & (alpha < C)))
        minus_yG = -y * G
        gi = torch.where(up, minus_yG, neg)
        i = _last_argmax(gi)
        Gmax = gi[ar, i]
        Gmax2 = torch.where(low, -minus_yG, neg).amax(dim=1)
        grad_diff = Gmax[:, None] + y * G  # Gmax - (-y_t G_t)
        Qi = q_row(i)
        quad = QD[ar, i][:, None] + QD - 2.0 * y[ar, i][:, None] * y * Qi
        quad = torch.where(quad > 0, quad, torch.full_like(quad, TAU))
        obj = torch.where(low & (grad_diff > 0), -(grad_diff * grad_diff) / quad,
                          torch.full_like(quad, torch.inf))
        j = _last_argmax(-obj)
        stop = (Gmax + Gmax2 < tol) | ~torch.isfinite(obj[ar, j])
        done = done | stop
        if it % CHECK_EVERY == 0 and bool(done.all()):
            break
        act = ~done
        yi, yj = y[ar, i], y[ar, j]
        ai, aj = alpha[ar, i], alpha[ar, j]
        Gi, Gj = G[ar, i], G[ar, j]
        Qij = Qi[ar, j]
        # the pair update of libsvm's Solver::Solve, both label cases at once
        diff_lab = yi != yj
        qc = torch.where(diff_lab, QD[ar, i] + QD[ar, j] + 2 * Qij,
                         QD[ar, i] + QD[ar, j] - 2 * Qij)
        qc = torch.where(qc > 0, qc, torch.full_like(qc, TAU))
        # y_i != y_j: both move by delta, their difference fixed
        d1 = (-Gi - Gj) / qc
        diff = ai - aj
        ni1, nj1 = ai + d1, aj + d1
        c1 = (diff > 0) & (nj1 < 0)
        ni1, nj1 = torch.where(c1, diff, ni1), torch.where(c1, 0.0, nj1)
        c2 = (diff <= 0) & (ni1 < 0)
        ni1, nj1 = torch.where(c2, 0.0, ni1), torch.where(c2, -diff, nj1)
        c3 = (diff > 0) & (ni1 > C)
        ni1, nj1 = torch.where(c3, C, ni1), torch.where(c3, C - diff, nj1)
        c4 = (diff <= 0) & (nj1 > C)
        ni1, nj1 = torch.where(c4, C + diff, ni1), torch.where(c4, C, nj1)
        # y_i == y_j: they move apart by delta, their sum fixed
        d2 = (Gi - Gj) / qc
        s = ai + aj
        ni2, nj2 = ai - d2, aj + d2
        e1 = (s > C) & (ni2 > C)
        ni2, nj2 = torch.where(e1, C, ni2), torch.where(e1, s - C, nj2)
        e2 = (s <= C) & (nj2 < 0)
        ni2, nj2 = torch.where(e2, s, ni2), torch.where(e2, 0.0, nj2)
        e3 = (s > C) & (nj2 > C)
        ni2, nj2 = torch.where(e3, s - C, ni2), torch.where(e3, C, nj2)
        e4 = (s <= C) & (ni2 < 0)
        ni2, nj2 = torch.where(e4, 0.0, ni2), torch.where(e4, s, nj2)
        ni = torch.where(diff_lab, ni1, ni2)
        nj = torch.where(diff_lab, nj1, nj2)
        ni, nj = torch.where(act, ni, ai), torch.where(act, nj, aj)
        dai, daj = ni - ai, nj - aj
        G = G + Qi * dai[:, None] + q_row(j) * daj[:, None]
        alpha[ar, i] = ni
        alpha[ar, j] = nj
        it += 1
    else:
        raise RuntimeError(f"the SVM's SMO did not meet its tolerance {tol} in {MAX_ITER} "
                           f"iterations ({int((~done).sum())} of {P} pairs open)")
    # libsvm's calculate_rho
    yG = y * G
    at_up, at_low = alpha >= C, alpha <= 0
    free = valid & ~at_up & ~at_low
    ub_set = valid & ((at_up & (y < 0)) | (at_low & (y > 0)))
    lb_set = valid & ((at_up & (y > 0)) | (at_low & (y < 0)))
    ub = torch.where(ub_set, yG, torch.full_like(yG, torch.inf)).amin(dim=1)
    lb = torch.where(lb_set, yG, torch.full_like(yG, -torch.inf)).amax(dim=1)
    n_free = free.sum(dim=1)
    rho = torch.where(n_free > 0, torch.where(free, yG, 0.0).sum(dim=1) / n_free.clamp_min(1),
                      (ub + lb) / 2)
    coef = torch.zeros((P, x.shape[0]), dtype=torch.float64, device=x.device)
    w = coef.scatter_add_(1, rows, alpha * y) @ x  # padding adds alpha y = 0 at row 0
    return {"classes": classes, "pairs": pairs, "w": w, "rho": rho, "iterations": it}


def decision_function(model: dict, z: torch.Tensor) -> torch.Tensor:
    """(n, P) decision values of every pair, in sklearn's ``ovo`` column
    order (class pairs (0, 1), (0, 2), ..., (1, 2), ...)."""
    return z.double() @ model["w"].T - model["rho"]


def predict(model: dict, z: torch.Tensor) -> torch.Tensor:
    """libsvm's one-vs-one vote: each pair votes for its first class when
    its decision value is positive, else for its second; the most votes win,
    a tie to the lower class."""
    dec = decision_function(model, z)
    pairs, classes = model["pairs"], model["classes"]
    winner = torch.where(dec > 0, pairs[:, 0], pairs[:, 1])
    votes = torch.nn.functional.one_hot(winner, len(classes)).sum(dim=1)
    return classes[torch.argmax(votes, dim=1)]  # the first of the largest: the lower class


def svm_accuracy(train_x: torch.Tensor, train_y: torch.Tensor, test_x: torch.Tensor,
                 test_y: torch.Tensor, C: float = 0.01) -> float:
    """Test accuracy in percent of the linear C-SVC fitted on the train
    features (sklearn's ``SVC(C=C, kernel='linear').fit(...).score(...)``
    times 100)."""
    model = fit_ovo(train_x, train_y, C=C)
    return float((predict(model, test_x) == test_y.to(test_x.device)).double().mean()) * 100.0
