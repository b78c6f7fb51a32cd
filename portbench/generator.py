"""The one traffic generator: recordings of speaker turns, from a seed.

A recording is a time-ordered sequence of speaker turns. Each speaker has a
centre ``randn(d) * centre_scale`` and each segment is its speaker's centre
plus ``randn(d) * noise``, float32 (the separation of the repository's
fixtures). Turn lengths are geometric with mean ``turn_mean`` segments;
each turn goes to a speaker other than the previous one, drawn by the
speakers' shares, which are Dirichlet(``share_alpha``).

A traffic file (``traffic/<name>.json``) gives the parameters. A run draws
a pool of ``pool`` recordings. Its sizes are the pool's quantiles of the
size distribution, in one fixed order, and its speaker counts the
largest-remainder split of ``pool`` by the speakers' weights: every seed
gets the same sizes in the same order and the same speaker counts, and the
seed only pairs counts with sizes and draws what each recording says. So
seeds change the inputs and hardly the amount of work.
"""

from __future__ import annotations

import dataclasses
import typing

import numpy as np


@dataclasses.dataclass
class Recording:
  index: int
  embeddings: np.ndarray          # (n, d) float32
  speakers: np.ndarray            # (n,) int, the true speaker of each segment
  n_speakers: int


def rng_for(seed: int, *stream: int) -> np.random.Generator:
  """A numpy generator for ``seed`` (any whole number) and a sub-stream."""
  return np.random.default_rng([int(seed) % (2**64), *stream])


def pool_sizes(traffic: dict) -> np.ndarray:
  """The pool's sizes: quantiles (i + 0.5) / pool of the size range."""
  pool = int(traffic["pool"])
  lo, hi = traffic["sizes"]["lo"], traffic["sizes"]["hi"]
  q = (np.arange(pool) + 0.5) / pool
  return np.rint(lo + (hi - lo) * q).astype(np.int64)


def pool_speakers(traffic: dict) -> np.ndarray:
  """The pool's speaker counts: ``pool`` split by the weights, largest
  remainder first."""
  pool = int(traffic["pool"])
  values = np.asarray(traffic["speakers"]["values"], np.int64)
  weights = np.asarray(traffic["speakers"]["weights"], np.float64)
  share = pool * weights / weights.sum()
  counts = np.floor(share).astype(np.int64)
  order = np.argsort(-(share - counts), kind="stable")
  counts[order[:pool - counts.sum()]] += 1
  return np.repeat(values, counts)


def turn_labels(rng: np.random.Generator, n: int, k: int, turn_mean: float,
                share_alpha: float) -> np.ndarray:
  """(n,) speaker of each segment: geometric turns, no speaker twice in a
  row, speakers drawn by Dirichlet shares."""
  shares = rng.dirichlet(np.full(k, float(share_alpha)))
  labels = np.empty(n, np.int64)
  pos, prev = 0, -1
  while pos < n:
    p = shares.copy()
    if prev >= 0:
      p[prev] = 0.0
    p = p / p.sum()
    spk = int(rng.choice(k, p=p))
    length = int(rng.geometric(1.0 / float(turn_mean)))
    labels[pos:pos + length] = spk
    pos += length
    prev = spk
  return labels


def make_recording(rng: np.random.Generator, index: int, n: int, k: int,
                   traffic: dict) -> Recording:
  d = int(traffic["d"])
  speakers = turn_labels(rng, n, k, traffic["turn_mean"],
                         traffic["share_alpha"])
  centres = rng.standard_normal((k, d)) * float(traffic["centre_scale"])
  noise = rng.standard_normal((n, d), dtype=np.float32)
  x = (centres[speakers].astype(np.float32)
       + noise * np.float32(traffic["noise"]))
  return Recording(index, x, speakers, k)


def make_pool(traffic: dict, seed: int) -> typing.List[Recording]:
  """The run's pool of recordings, in the order the window replays them.

  The sizes come in one fixed order for every seed (a shuffle of the
  quantiles by a constant stream), so that a window that ends part-way
  through a pass replays the same sizes whatever the seed; the seed pairs
  them with the speaker counts and draws the recordings."""
  sizes = pool_sizes(traffic)
  speakers = pool_speakers(traffic)
  sizes = sizes[np.random.default_rng(0).permutation(sizes.size)]
  speakers = speakers[rng_for(seed, 0).permutation(speakers.size)]
  return [make_recording(rng_for(seed, 1, i), i, int(n), int(k), traffic)
          for i, (n, k) in enumerate(zip(sizes, speakers))]
