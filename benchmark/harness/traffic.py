"""The one generator of the benchmark's traffic: it reads a traffic mix's
data file (``benchmark/traffic/<name>.json``) and draws every request from
the run's seed.

A fleet mix (``"kind": "fleet"``) is ``robots`` robots on one server, in
one of two loops (``"loop"``):

- ``"open"``: each robot sends a frame and an instruction every
  ``period_s`` seconds whether or not its last answer has come (it keeps
  acting on its last action chunk meanwhile). Robot r sends its request k
  at ``(r + phase[r]) * period_s / robots + k * period_s``, where ``phase``
  is one fixed pattern (``PHASE_SEED``), the same for every run seed: every
  seed sends the same arrivals.
- ``"closed"``: every robot sends its first request when the window opens
  and each next one as soon as the last is answered, so the server always
  holds ``robots`` requests; with more robots than its batches take, it
  runs at whatever rate it sustains. Frames are made before the window for
  ``premade_rps`` requests a second; a robot that sends more has the rest
  made when it sends them.

Request (robot, k) is a frame of uniform random RGB bytes and an
instruction of n words drawn from the mix's vocabulary, where n runs
through every count of the mix's ``words`` range once per cycle, in an
order the seed shuffles for each robot: every seed sends the same sizes, in
another order. Any request can be made again from (seed, robot, k) alone,
as the reference does after the window.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

SEED_MASK = (1 << 64) - 1
PHASE_SEED = 20250117  # the robots' clock phases, one pattern for every run seed


@dataclass(frozen=True)
class Request:
    client: int
    index: int
    frame: np.ndarray  # (H, W, 3) uint8
    instruction: str


class Fleet:
    def __init__(self, mix: dict, seed: int):
        self.mix = mix
        self.seed = int(seed) & SEED_MASK
        self.clients = int(mix["robots"])
        self.loop = mix.get("loop", "open")
        if self.loop not in ("open", "closed"):
            raise ValueError(f"unknown loop {self.loop!r}")
        self.period_s = float(mix["period_s"]) if self.loop == "open" else None
        self.phase = np.random.default_rng(PHASE_SEED).random(self.clients)
        lo, hi = mix["instruction"]["words"]
        self.counts = np.arange(lo, hi + 1)
        self.vocabulary = list(mix["instruction"]["vocabulary"])
        f = mix["frame"]
        self.frame_shape = (f["height"], f["width"], f["channels"])

    def arrivals(self, seconds: float) -> list:
        """(due second, robot, k) of every request due in [0, seconds), in
        order of time (an open loop)."""
        if self.loop != "open":
            raise ValueError("a closed loop has no arrivals fixed in advance")
        out = []
        for r in range(self.clients):
            first = (r + self.phase[r]) * self.period_s / self.clients
            for k in range(int(np.ceil((seconds - first) / self.period_s)) if seconds > first else 0):
                out.append((first + k * self.period_s, r, k))
        return sorted(out)

    def premade(self, seconds: float) -> list:
        """(robot, k) of the requests whose frames are made before a window
        of ``seconds``: those due in it (open loop), or the first
        ``premade_rps * seconds / robots`` of each robot (closed loop)."""
        if self.loop == "open":
            return [(r, k) for _, r, k in self.arrivals(seconds)]
        each = int(np.ceil(float(self.mix["premade_rps"]) * seconds / self.clients))
        return [(r, k) for r in range(self.clients) for k in range(each)]

    def _rng(self, *key) -> np.random.Generator:
        return np.random.default_rng([self.seed, *key])

    def words(self, client: int, index: int) -> int:
        """The word count of request (client, index)."""
        cycle, pos = divmod(index, len(self.counts))
        order = self._rng(0, client, cycle).permutation(self.counts)
        return int(order[pos])

    def request(self, client: int, index: int) -> Request:
        rng = self._rng(1, client, index)
        n = self.words(client, index)
        words = rng.choice(len(self.vocabulary), size=n)
        frame = rng.integers(0, 256, size=self.frame_shape, dtype=np.uint8)
        return Request(client, index, frame, " ".join(self.vocabulary[w] for w in words))

    def longest_instruction(self) -> str:
        """An instruction as long in bytes as the mix can make, for warm-up."""
        word = max(self.vocabulary, key=len)
        return " ".join([word] * int(self.counts[-1]))

    def sample(self, done: list, n: int) -> list:
        """n of the finished requests ``done`` (each with .client, .index,
        .instruction), drawn from the seed, the one with the longest
        instruction first among them."""
        if not done:
            return []
        longest = max(range(len(done)), key=lambda i: (len(done[i].instruction.encode()), -i))
        rest = [i for i in range(len(done)) if i != longest]
        pick = self._rng(2).permutation(rest)[: max(n - 1, 0)]
        return [done[longest]] + [done[i] for i in sorted(pick)]


def make(mix: dict, seed: int):
    """The generator for a traffic mix's data."""
    kinds = {"fleet": Fleet}
    if mix.get("kind") not in kinds:
        raise ValueError(f"unknown traffic kind {mix.get('kind')!r}")
    return kinds[mix["kind"]](mix, seed)
