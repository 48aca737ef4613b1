"""Faults planted under the timed path, for the tests that see ``correct``
come out false and for the readings that set a limit's upper end.  Each
replaces one function of the program for the length of a ``with`` block:

- ``unchanged``: a train step that computes its loss and returns the state
  as it was given (no backward, no update);
- ``half_batch``: a train step on the first half of the batch's rows, the
  mean taken over them;
- ``token``: one window byte of each batch altered where the sampler makes
  it;
- ``chain_unlinked``: chain links that draw without the last link's digest,
  so the chain's key never advances;
- ``chain_half``: a chain digest over the first half of a link's windows;
- ``chain_answer``: each ``sample_chain`` answer off by one.
"""

from __future__ import annotations

import contextlib


def _train_step_faults(name, original):
    from haplohyped_tpu_torch.models.train import TrainState, loss_fn

    def unchanged(state, hap1, hap2, n_variants, mesh=None):
        loss, aux = loss_fn(state.model, hap1, hap2, n_variants)
        return TrainState(state.model, state.optimizer, state.step + 1, mesh), {
            "loss": loss.detach(), **{k: v.detach() for k, v in aux.items()}}

    def half_batch(state, hap1, hap2, n_variants, mesh=None):
        h = hap1.shape[0] // 2
        return original(state, hap1[:h], hap2[:h], n_variants[:h], mesh)

    return {"unchanged": unchanged, "half_batch": half_batch}[name]


@contextlib.contextmanager
def planted(name: str | None):
    """Plant fault ``name`` (None: none) inside the block."""
    if name is None:
        yield
        return
    from haplohyped_tpu_torch.data import sampler as sampler_mod
    from haplohyped_tpu_torch.models import train as train_mod

    cls = sampler_mod.DeviceHaplotypeSampler
    if name in ("unchanged", "half_batch"):
        where, attr = train_mod, "_train_step"
        new = _train_step_faults(name, train_mod._train_step)
    elif name == "token":
        where, attr = cls, "_encode"
        encode = cls._encode

        def new(self, *a, **k):
            b = encode(self, *a, **k)
            b.hap1_codes[0, 0] = (b.hap1_codes[0, 0] + 1) % 4
            return b
    elif name == "chain_unlinked":
        where, attr = cls, "_draws"
        draws = cls._draws

        def new(self, key, step0, n_batches, kernel=None, digest=None):
            return draws(self, key, step0, n_batches, kernel, None)
    elif name == "chain_half":
        where, attr = sampler_mod, "chain_digest"
        digest = sampler_mod.chain_digest

        def new(batch):
            n = batch.hap1_codes.shape[0] // 2
            return digest(type(batch)(*(t[:n] for t in batch)))
    elif name == "chain_answer":
        where, attr = cls, "sample_chain"
        sample_chain = cls.sample_chain

        def new(self, *a, **k):
            return sample_chain(self, *a, **k) + 1
    else:
        raise ValueError(f"unknown fault {name!r}")
    old = getattr(where, attr)
    setattr(where, attr, new)
    try:
        yield
    finally:
        setattr(where, attr, old)
