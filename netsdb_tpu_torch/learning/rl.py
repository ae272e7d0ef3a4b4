"""Deep-RL placement learner — the port's ``netsdb_tpu/learning/rl.py``,
the Lachesis DRL mode, copied so that one seed gives the same weights,
choices and updates bit for bit.

The reference optionally routes placement decisions through a separate
TensorFlow A3C process: the C++ ``RLClient`` (``src/selfLearning/
headers/RLClient.h:18-38``) sends a JSON state vector + last reward over
TCP and receives an action index from ``scripts/pangeaDeepRL/
rlServer.py`` (state dim ``S_DIM = 4*K + 7``, action space ``A_DIM =
K + 1`` — K candidate partition lambdas plus "no partition";
actor/critic nets in ``a3c.py``; enabled by
``-DAPPLY_REINFORCEMENT_LEARNING``). Here the action space is the K
candidates without the extra "no partition" arm: on a mesh some
sharding is always chosen, so opting out isn't an action. The DRL placement optimizer
(``DRLBasedDataPlacementOptimizerForLoadJob.h``) builds the state from
job-history stats for each candidate.

Here the learner is in-process (single-controller — no socket hop to
ourselves): an actor-critic with a linear softmax policy and linear
value baseline over the same state layout (per-candidate feature
blocks + global features), trained online from measured wall-time
rewards. NumPy, not torch: the nets are a few hundred parameters and run
on the host between jobs — putting them on the card would cost more in
launches than the math. :class:`DRLPlacementAdvisor` is a drop-in
alternative to the frequency-based
:class:`~netsdb_tpu_torch.learning.advisor.PlacementAdvisor`.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from netsdb_tpu_torch.learning.advisor import PlacementCandidate
from netsdb_tpu_torch.learning.history import HistoryDB, get_history_db

# Per-candidate feature block size and global feature count — same state
# layout as the reference server (S_DIM = PER_CANDIDATE*K + GLOBAL).
PER_CANDIDATE = 4
GLOBAL = 7


def state_dim(num_candidates: int) -> int:
    return PER_CANDIDATE * num_candidates + GLOBAL


class ActorCritic:
    """Linear softmax policy + linear value baseline, REINFORCE-with-
    baseline updates (the reference's a3c.py actor/critic pair, minus
    the asynchrony — decisions arrive one at a time here anyway)."""

    def __init__(self, state_dim: int, num_actions: int,
                 actor_lr: float = 0.05, critic_lr: float = 0.1,
                 entropy_beta: float = 0.01, seed: int = 0):
        rng = np.random.default_rng(seed)
        self.w_pi = rng.normal(0, 0.01, (num_actions, state_dim))
        self.b_pi = np.zeros(num_actions)
        self.w_v = np.zeros(state_dim)
        self.b_v = 0.0
        self.actor_lr = actor_lr
        self.critic_lr = critic_lr
        self.entropy_beta = entropy_beta
        self.rng = rng

    def policy(self, state: np.ndarray) -> np.ndarray:
        logits = self.w_pi @ state + self.b_pi
        logits -= logits.max()
        p = np.exp(logits)
        return p / p.sum()

    def value(self, state: np.ndarray) -> float:
        return float(self.w_v @ state + self.b_v)

    def act(self, state: np.ndarray, explore: bool = True) -> int:
        p = self.policy(state)
        if explore:
            return int(self.rng.choice(len(p), p=p))
        return int(np.argmax(p))

    def learn(self, state: np.ndarray, action: int, reward: float) -> None:
        """One-step advantage update: A = r - V(s); ∇logπ(a|s)·A for the
        actor (+entropy bonus), squared-error for the critic."""
        state = np.asarray(state, np.float64)
        # normalized-LMS step scale: keeps the linear heads stable for
        # any O(1) lr regardless of state magnitude
        norm = 1.0 + float(state @ state)
        adv = np.clip(reward - self.value(state), -5.0, 5.0)
        p = self.policy(state)
        # d logits = (onehot(a) - p) * adv  +  entropy gradient
        grad_logits = -p * adv
        grad_logits[action] += adv
        ent_grad = -p * (np.log(p + 1e-12) + 1.0)  # d entropy / d logits
        ent_grad -= p * ent_grad.sum()
        grad_logits += self.entropy_beta * ent_grad
        self.w_pi += (self.actor_lr / norm) * np.outer(grad_logits, state)
        self.b_pi += self.actor_lr * grad_logits
        self.w_v += (self.critic_lr / norm) * adv * state
        self.b_v += self.critic_lr * adv


def build_state(candidate_stats: Sequence[Sequence[float]],
                global_stats: Sequence[float]) -> np.ndarray:
    """Assemble the state vector: K blocks of PER_CANDIDATE features
    (e.g. candidate's historical mean time, run count, data volume,
    recency) then GLOBAL features (set size, page count, …), matching
    the reference layout. Blocks are zero-padded/truncated."""
    parts: List[float] = []
    for s in candidate_stats:
        block = list(s)[:PER_CANDIDATE]
        block += [0.0] * (PER_CANDIDATE - len(block))
        parts += block
    g = list(global_stats)[:GLOBAL]
    g += [0.0] * (GLOBAL - len(g))
    return np.asarray(parts + g, np.float64)


class DRLPlacementAdvisor:
    """Choose a placement candidate for a job with the actor-critic,
    rewarding measured speed — the DRL counterpart of
    :class:`~netsdb_tpu_torch.learning.advisor.PlacementAdvisor` (reference
    ``DRLBasedDataPlacementOptimizerForLoadJob.h``). Reward is
    ``-elapsed / reference_time`` so it is scale-free across jobs."""

    def __init__(self, candidates: Sequence[PlacementCandidate],
                 db: Optional[HistoryDB] = None, seed: int = 0,
                 actor_lr: float = 0.05, critic_lr: float = 0.1):
        if not candidates:
            raise ValueError("need at least one candidate")
        self.candidates = list(candidates)
        self.db = db or get_history_db()
        self.net = ActorCritic(state_dim(len(candidates)),
                               len(self.candidates),
                               actor_lr=actor_lr, critic_lr=critic_lr,
                               seed=seed)
        self._ref_time: Dict[str, float] = {}

    # --- state from history ------------------------------------------
    def _state(self, job_name: str) -> np.ndarray:
        cand_stats = []
        runs = self.db.runs(job_name)
        total = max(len(runs), 1)
        for c in self.candidates:
            mine = [r for r in runs if r["config"] == c.label]
            mean_t = self.db.mean_elapsed(job_name, c.label)
            ref = self._ref_time.get(job_name)
            cand_stats.append([   # all features bounded O(1): the linear
                                  # heads need comparable scales to stay stable
                math.tanh(mean_t / ref) if (mean_t is not None and ref) else 0.0,
                len(mine) / total,
                math.log2(max(float(np.prod(c.mesh_shape)), 1.0)) / 8.0,
                1.0 if mine else 0.0,
            ])
        global_stats = [math.tanh(len(runs) / 10.0),
                        math.log2(max(len(self.candidates), 1)) / 4.0,
                        1.0 if self._ref_time.get(job_name) else 0.0,
                        0.0, 0.0, 0.0, 0.0]
        return build_state(cand_stats, global_stats)

    # --- RLClient-compatible surface ---------------------------------
    def choose(self, job_name: str, explore: bool = True,
               ) -> PlacementCandidate:
        return self.candidates[self.net.act(self._state(job_name), explore)]

    def record(self, job_name: str, candidate: PlacementCandidate,
               elapsed_s: float) -> None:
        """Report the measured time: reward the policy and persist the
        run to the history DB (the reference writes RUN_STAT rows)."""
        state = self._state(job_name)  # state as seen at decision time
        # first measurement anchors the scale; guard zero (cached result /
        # coarse timer) so the division and the cached ref stay finite
        ref = self._ref_time.setdefault(job_name, elapsed_s or 1e-9)
        reward = -elapsed_s / ref
        action = self.candidates.index(candidate)
        self.net.learn(state, action, reward)
        self.db.record(job_name, plan_key="", elapsed_s=elapsed_s,
                       config_label=candidate.label)

    def measure_and_choose(self, job_name: str,
                           run: Callable[[PlacementCandidate], float],
                           rounds: int = 12) -> PlacementCandidate:
        """Explore/learn loop, then return the greedy choice — the
        'first runs slow, later runs fast' behavior the reference's
        experiments report (documentation.md:5-10)."""
        for _ in range(rounds):
            cand = self.choose(job_name, explore=True)
            self.record(job_name, cand, run(cand))
        return self.choose(job_name, explore=False)
