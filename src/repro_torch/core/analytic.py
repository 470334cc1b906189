"""Paper analytic models: MFU-loss decomposition (§3.1), checkpoint-time
formulas (§2/§4.2), failure probabilities (Table 2) and recovery probability
Eqs. (3)-(5) (§6.2).

The port's own copy of ``repro.core.analytic``: pure arithmetic, the same
functions with the same names and signatures."""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

HOUR = 3600.0
GPU_MTBF_HOURS = 80_000.0  # per-GPU MTBF (paper §3.1)


# --------------------------------------------------------------------------- #
# Checkpoint timing (paper §2, §4.2)
# --------------------------------------------------------------------------- #
def compute_time(s: float, b: float, phi: float, c: float) -> float:
    """T_c = 6 s b phi / C : fwd+bwd compute seconds for phi params/device."""
    return 6.0 * s * b * phi / c


def ckpt_time_full(phi: float, v: float, i: float) -> float:
    """Traditional engine: persist weights+optimizer over network (V) and disk
    (I): T_ckpt = 16 phi (V + I) / (V I)."""
    return 16.0 * phi * (v + i) / (v * i)


def ckpt_time_razor(phi: float, v: float) -> float:
    """FFTrainer: unique Adam state only, to a neighbor over the training
    network: T'_ckpt = 12 phi / V."""
    return 12.0 * phi / v


# --------------------------------------------------------------------------- #
# MFU loss (paper §3.1): L = L_ckpt + L_recover + L_rollback
# --------------------------------------------------------------------------- #
@dataclass(frozen=True)
class MfuLoss:
    ckpt: float
    recover: float
    rollback: float

    @property
    def total(self) -> float:
        return self.ckpt + self.recover + self.rollback


def mfu_loss(t_ckpt: float, t_interval: float, mttr: float,
             mtbf: float) -> MfuLoss:
    """All times in seconds; t_interval is the CKPT interval. Each component
    is capped at 1 (the paper's formulas are small-ratio approximations that
    exceed 1 when e.g. the CKPT interval exceeds the MTBF)."""
    l_ckpt = min(t_ckpt / (t_interval + t_ckpt), 1.0) if t_ckpt else 0.0
    l_recover = min(mttr / (mtbf + mttr), 1.0)
    l_rollback = min((t_interval / 2.0) / (mtbf + mttr), 1.0)
    return MfuLoss(l_ckpt, l_recover, l_rollback)


def cluster_failure_probability(n_gpus: int, horizon_hours: float,
                                gpu_mtbf_hours: float = GPU_MTBF_HOURS) -> float:
    """P that a cluster of n GPUs sees >=1 failure within the horizon
    (Table 2's P_x columns)."""
    return 1.0 - math.exp(-n_gpus * horizon_hours / gpu_mtbf_hours)


def cluster_mtbf_hours(n_gpus: int,
                       gpu_mtbf_hours: float = GPU_MTBF_HOURS) -> float:
    return gpu_mtbf_hours / max(n_gpus, 1)


# --------------------------------------------------------------------------- #
# Recovery probability, Eqs. (3)-(5)
# --------------------------------------------------------------------------- #
def _log_comb(n: int, k: int) -> float:
    if k < 0 or k > n:
        return -math.inf
    return (math.lgamma(n + 1) - math.lgamma(k + 1) - math.lgamma(n - k + 1))


def recovery_prob_given_k(n: int, k: int) -> float:
    """Eq. (3): P that no failed machine's DP-ring neighbor also failed —
    the count of k non-adjacent picks on an N-cycle over C(N,k)."""
    if k <= 1:
        return 1.0
    if 2 * k > n:
        return 0.0
    num = (math.exp(_log_comb(n - k, k) - _log_comb(n, k))
           + math.exp(_log_comb(n - k - 1, k - 1) - _log_comb(n, k)))
    return float(min(num, 1.0))


def k_failure_prob(n: int, k: int, hours: float,
                   gpu_mtbf_hours: float = GPU_MTBF_HOURS,
                   gpus_per_host: int = 8) -> float:
    """Eq. (4): P(exactly k of N hosts fail within `hours`)."""
    mu = gpus_per_host / gpu_mtbf_hours
    p = 1.0 - math.exp(-mu * hours)
    if p <= 0.0:
        return 1.0 if k == 0 else 0.0
    logp = (_log_comb(n, k) + k * math.log(p) + (n - k) * math.log1p(-p))
    return math.exp(logp)


def recovery_probability(n: int, hours: float,
                         gpu_mtbf_hours: float = GPU_MTBF_HOURS,
                         gpus_per_host: int = 8, k_max: int = None) -> float:
    """Eq. (5): P(N,H) = sum_k P_r(N,k) P_f(N,k,H)."""
    if k_max is None:
        # adaptive: sum until the tail is negligible
        mu = gpus_per_host / gpu_mtbf_hours
        p = 1.0 - math.exp(-mu * hours)
        k_max = min(n, max(16, int(4 * n * p + 16)))
    total = 0.0
    for k in range(0, k_max + 1):
        total += recovery_prob_given_k(n, k) * k_failure_prob(
            n, k, hours, gpu_mtbf_hours, gpus_per_host)
    return min(total, 1.0)


def gemini_recovery_probability(n: int, hours: float, m: int = 2,
                                gpu_mtbf_hours: float = GPU_MTBF_HOURS,
                                gpus_per_host: int = 8,
                                samples: int = 200_000,
                                seed: int = 0) -> float:
    """Gemini-style m-replica placement (checkpoint kept on self + next m-1
    machines): recovery fails iff some machine AND all its replica holders
    fail. Monte-Carlo (documented; exact closed form exists only for m=2)."""
    rng = np.random.default_rng(seed)
    mu = gpus_per_host / gpu_mtbf_hours
    p = 1.0 - math.exp(-mu * hours)
    fail = rng.random((samples, n)) < p
    ok = np.ones(samples, dtype=bool)
    lost = fail.copy()
    for j in range(1, m):
        lost &= np.roll(fail, -j, axis=1)
    ok = ~lost.any(axis=1)
    return float(ok.mean())
