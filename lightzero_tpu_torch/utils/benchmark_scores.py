"""Benchmark score tables and human-normalized statistics (a copy of
``lightzero_tpu/utils/benchmark_scores.py``, which the port does not import).

The tables are keyed by game name, so task ids resolve through the config's
task name. The constants are the published Atari-100k table (random policy
and human expert scores over the 26-game suite) and the fixed [0, 1000]
anchors of DeepMind Control.
"""
from typing import Dict, Optional, Tuple

import numpy as np

# (random, human) per Atari-100k game
ATARI100K_SCORES: Dict[str, Tuple[float, float]] = {
    "Alien": (227.8, 7127.7),
    "Amidar": (5.8, 1719.5),
    "Assault": (222.4, 742.0),
    "Asterix": (210.0, 8503.3),
    "BankHeist": (14.2, 753.1),
    "BattleZone": (2360.0, 37187.5),
    "Boxing": (0.1, 12.1),
    "Breakout": (1.7, 30.5),
    "ChopperCommand": (811.0, 7387.8),
    "CrazyClimber": (10780.5, 35829.4),
    "DemonAttack": (152.1, 1971.0),
    "Freeway": (0.0, 29.6),
    "Frostbite": (65.2, 4334.7),
    "Gopher": (257.6, 2412.5),
    "Hero": (1027.0, 30826.4),
    "Jamesbond": (29.0, 302.8),
    "Kangaroo": (52.0, 3035.0),
    "Krull": (1598.0, 2665.5),
    "KungFuMaster": (258.5, 22736.3),
    "MsPacman": (307.3, 6951.6),
    "Pong": (-20.7, 14.6),
    "PrivateEye": (24.9, 69571.3),
    "Qbert": (163.9, 13455.0),
    "RoadRunner": (11.5, 7845.0),
    "Seaquest": (68.4, 42054.7),
    "UpNDown": (533.4, 11693.2),
}

# DeepMind Control: returns live in [0, 1000] by construction, so the
# normalization anchors are fixed (reference benchmark_name == "dmc").
DMC_SCORES: Tuple[float, float] = (0.0, 1000.0)


def _canon(name: str) -> str:
    """'ms_pacman' / 'MsPacmanNoFrameskip-v4' / 'mspacman' -> 'MsPacman'."""
    stem = name.split("NoFrameskip")[0].split("-")[0].replace("_", "").lower()
    for game in ATARI100K_SCORES:
        if game.lower() == stem:
            return game
    return name


def human_normalized(score: float, game: str, benchmark: str = "atari") -> Optional[float]:
    """(score - random) / (human - random); None if the game is unknown."""
    if benchmark == "dmc":
        rnd, hum = DMC_SCORES
    else:
        key = _canon(game)
        if key not in ATARI100K_SCORES:
            return None
        rnd, hum = ATARI100K_SCORES[key]
    return (float(score) - rnd) / (hum - rnd)


def normalized_stats(
    eval_returns: Dict[str, Optional[float]], benchmark: str = "atari"
) -> Tuple[Optional[float], Optional[float]]:
    """Human-normalized mean and median over per-task eval returns keyed by
    task/game name; tasks with no return yet (None) or unknown names are
    skipped. (None, None) when nothing is valid — matching the reference's
    compute_unizero_mt_normalized_stats contract."""
    vals = []
    for name, ret in eval_returns.items():
        if ret is None:
            continue
        hn = human_normalized(ret, name, benchmark)
        if hn is not None:
            vals.append(hn)
    if not vals:
        return None, None
    arr = np.asarray(vals, np.float64)
    return float(arr.mean()), float(np.median(arr))
