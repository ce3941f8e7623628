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
"""

import torch


def step_seed(seed: int, step: int) -> int:
    """The generator seed of step ``step`` of a run seeded with ``seed``."""
    return (int(seed) * 2**32 + int(step)) % 2**64


class Draws:
    """Uniform, exponential, normal and integer draws from one
    ``torch.Generator``."""

    def __init__(self, generator: torch.Generator):
        self.generator = generator
        self.device = generator.device

    @classmethod
    def for_step(cls, seed: int, step: int, device) -> "Draws":
        g = torch.Generator(device=device)
        g.manual_seed(step_seed(seed, step))
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
