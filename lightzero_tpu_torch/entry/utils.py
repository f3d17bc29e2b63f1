"""Entry utilities (``lightzero_tpu/entry/utils.py``): warm-up random
collection, the replay-ratio update count and evaluation under a timeout."""
from __future__ import annotations

import threading
from typing import Dict, Optional


def random_collect(collector, buffer, num_episodes: int = 8) -> Dict:
    """Warm-up collection with uniform-random legal actions: the normal
    collector at epsilon=1, so every action is random while the search's
    statistics are still recorded for the buffer."""
    episodes, priorities, stats = collector.collect(
        temperature=1.0, epsilon=1.0, num_episodes=num_episodes
    )
    buffer.push_episodes(episodes, priorities)
    return stats


def calculate_update_per_collect(cfg, collected_transitions: int) -> int:
    """``update_per_collect`` when the config sets it, else the collected
    transitions times ``replay_ratio`` (at least 1)."""
    upc = cfg.get("update_per_collect", None)
    if upc is not None:
        return int(upc)
    return max(1, int(collected_transitions * float(cfg.get("replay_ratio", 0.25))))


def safe_eval(evaluator, n_episodes: Optional[int] = None, timeout_s: float = 600.0) -> Optional[Dict]:
    """``evaluator.eval`` in a thread with a timeout, so that a hung
    evaluation cannot stall the trainer. Returns None on timeout (the daemon
    thread is abandoned); an error in the evaluation is raised here."""
    result = {}
    error = []

    def run():
        try:
            result.update(evaluator.eval(n_episodes=n_episodes))
        except Exception as e:  # handed to the caller's thread below
            error.append(e)

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(timeout_s)
    if t.is_alive():
        return None
    if error:
        raise error[0]
    return result
