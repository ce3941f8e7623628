"""The random numbers of the training path, from one explicit source.

JAX derives a train step's randomness from ``fold_in(base_key, step)``; the
port derives it from (seed, step) by seeding a ``torch.Generator`` on the
run's device, so a resumed run draws what an unbroken run would. Every
randomized function of the port takes its numbers from a ``Draws`` object, in
the order the step asks for them: the batch indices, the coarse jitter, the
fine exponential draws (and, for fresh latent codes, normal draws). With
``noise_std`` > 0 a model also asks for each level's sigma noise
(``noise``) after that level's samples; without it the sequence is what it
was. A test can pass any object with the same methods, for example one that
returns numbers drawn with JAX.

Data parallelism: the articulated steps' ranks each draw their own batch
from ``Draws.for_step(seed, step, fold=rank)`` (JAX folds
``axis_index('data')`` into the step's key); the vanilla step's ranks draw
the whole batch's numbers and keep their own rows (``RowDraws``), so the
ranks together compute the one-device step.
"""

import torch


def step_seed(seed: int, step: int) -> int:
    """The generator seed of step ``step`` of a run seeded with ``seed``."""
    return (int(seed) * 2**32 + int(step)) % 2**64


def fold_seed(seed: int, data: int) -> int:
    """A generator seed for ``data`` (a rank) folded into ``seed``, as JAX's
    ``fold_in``: splitmix64's finalizer of seed + (data + 1) * its golden
    gamma, so every (seed, data) pair gets its own stream."""
    m = 2**64 - 1
    z = (int(seed) + (int(data) + 1) * 0x9E3779B97F4A7C15) & m
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & m
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & m
    return z ^ (z >> 31)


class Draws:
    """Uniform, exponential, normal and integer draws from one
    ``torch.Generator``."""

    def __init__(self, generator: torch.Generator):
        self.generator = generator
        self.device = generator.device

    @classmethod
    def for_step(cls, seed: int, step: int, device, fold=None) -> "Draws":
        """The draws of step ``step``; with ``fold`` (a data-parallel rank)
        that rank's own stream of the step."""
        s = step_seed(seed, step)
        g = torch.Generator(device=device)
        g.manual_seed(s if fold is None else fold_seed(s, fold))
        return cls(g)

    def randint(self, high: int, shape) -> torch.Tensor:
        """Integers in [0, high)."""
        return torch.randint(0, high, tuple(shape), generator=self.generator, device=self.device)

    def uniform(self, shape) -> torch.Tensor:
        """float32 in [0, 1)."""
        return torch.rand(tuple(shape), generator=self.generator, device=self.device)

    def noise(self, shape) -> torch.Tensor:
        """float32 in [0, 1): a level's sigma noise, before the model
        scales it by noise_std (a uniform draw, as JAX's)."""
        return self.uniform(shape)

    def exponential(self, shape) -> torch.Tensor:
        """float32 Exp(1)."""
        out = torch.empty(tuple(shape), dtype=torch.float32, device=self.device)
        return out.exponential_(generator=self.generator)

    def normal(self, shape) -> torch.Tensor:
        """float32 N(0, 1)."""
        return torch.randn(tuple(shape), generator=self.generator, device=self.device)


class RowDraws:
    """A draws object for rows [start, stop) of a batch of ``total`` rows:
    each call draws the whole batch's array from ``draws`` (leading size
    ``total``) and hands out those rows, so every rank takes its rows of
    the numbers one device would draw, in the same order."""

    def __init__(self, draws, start: int, stop: int, total: int):
        self.draws, self.start, self.stop, self.total = draws, start, stop, total

    def _rows(self, draw, shape):
        shape = tuple(shape)
        assert shape[0] == self.stop - self.start, (shape, self.start, self.stop)
        return draw((self.total, *shape[1:]))[self.start : self.stop]

    def randint(self, high: int, shape) -> torch.Tensor:
        return self._rows(lambda s: self.draws.randint(high, s), shape)

    def uniform(self, shape) -> torch.Tensor:
        return self._rows(self.draws.uniform, shape)

    def noise(self, shape) -> torch.Tensor:
        return self._rows(self.draws.noise, shape)

    def exponential(self, shape) -> torch.Tensor:
        return self._rows(self.draws.exponential, shape)

    def normal(self, shape) -> torch.Tensor:
        return self._rows(self.draws.normal, shape)
