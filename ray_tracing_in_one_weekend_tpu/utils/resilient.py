"""Elastic recovery: batch-grain retry on device failure (SURVEY.md §5).

The reference's only failure handling is fail-stop:
`checkCudaErrors` prints and `exit(99)`
(reference: src/gpu/cuda_utility.h:8-18). SURVEY.md §5 calls per-host
fail-stop acceptable parity and lists batch/tile-grain re-render as the
optional upgrade — this module is that upgrade, built on the
checkpoint accumulator's algebra (utils/checkpoint.py): because every
sample draws from a stream keyed by the GLOBAL (pixel, sample) index,
a failed batch can simply be re-rendered — same inputs, same global
sample window — and folded in later, with the final image BIT-IDENTICAL
to an unfailed run. No partial state is lost because `accumulate` is
functional: a batch that raises or returns non-finite pixels leaves the
previous `RenderState` untouched.

Failure model: transient device faults — preempted/restarted device
runtime calls, interconnect hiccups, or data corruption surfacing as
non-finite pixels. Deterministic failures (a bug) exhaust the retry
budget and re-raise: fail-stop remains the backstop, matching the
reference's semantics when recovery is impossible.
"""

from __future__ import annotations

import sys
import time
from dataclasses import dataclass, field

import jax.numpy as jnp

from ray_tracing_in_one_weekend_tpu.utils import checkpoint as ckpt


@dataclass
class RetryStats:
    """Recovery telemetry for one resilient render."""

    batches: int = 0
    retries: int = 0
    failures: list = field(default_factory=list)  # (batch_start, kind, detail)


class BatchCorruptError(RuntimeError):
    """A rendered batch contained non-finite pixels."""


class CheckpointCorruptError(RuntimeError):
    """A LOADED checkpoint contained non-finite pixels — re-rendering
    batches can never fix this; delete or re-create the checkpoint."""


def validate_state(state: ckpt.RenderState) -> None:
    """Guard a freshly loaded checkpoint ONCE, with a distinct error:
    a NaN inherited from disk would otherwise make every batch retry
    fail with a misleading 'corrupt batch' message (retries re-render
    the batch, which cannot repair pre-existing state)."""
    if not bool(jnp.all(jnp.isfinite(state.accum))):
        raise CheckpointCorruptError(
            "non-finite pixels in LOADED checkpoint state — delete the "
            "checkpoint file and re-render"
        )


def _validate(new_state: ckpt.RenderState, prev: ckpt.RenderState) -> None:
    # The float-guard analogue of checkCudaErrors' post-call check
    # (utils/debug.py has the checkify form for jit-internal guards;
    # here the batch boundary is a natural host sync point). Only the
    # NEW batch's contribution is checked — prev.accum is validated at
    # load time (validate_state), so a non-finite delta implicates this
    # batch and a retry is the right remedy.
    delta = new_state.accum - prev.accum
    if not bool(jnp.all(jnp.isfinite(delta))):
        raise BatchCorruptError("non-finite pixels in rendered batch")


def accumulate_resilient(
    state: ckpt.RenderState,
    scene,
    cam,
    base_key,
    spp_batch: int,
    *,
    max_retries: int = 2,
    stats: RetryStats | None = None,
    retry_delay_s: float = 0.0,
    log=None,
    **accumulate_kw,
) -> ckpt.RenderState:
    """`checkpoint.accumulate` with batch-grain retry.

    Attempts the batch up to 1 + max_retries times; each attempt
    re-renders the SAME global sample window [spp_done, spp_done+batch)
    so a successful retry is indistinguishable from never having
    failed. Raises the last error when the budget is exhausted.
    """
    log = log or (lambda *a: print(*a, file=sys.stderr, flush=True))
    last_err = None
    for attempt in range(1 + max_retries):
        try:
            new_state = ckpt.accumulate(
                state, scene, cam, base_key, spp_batch, **accumulate_kw
            )
            _validate(new_state, state)
            if stats is not None:
                stats.batches += 1
            return new_state
        except Exception as e:  # noqa: BLE001 — retry any device fault
            last_err = e
            if stats is not None:
                stats.retries += 1
                stats.failures.append(
                    (int(state.spp_done), type(e).__name__, str(e)[:200])
                )
            log(
                f"resilient: batch at spp={int(state.spp_done)} failed "
                f"({type(e).__name__}: {str(e)[:120]}) — "
                f"retry {attempt + 1}/{max_retries}"
                if attempt < max_retries
                else f"resilient: batch at spp={int(state.spp_done)} failed "
                     f"after {max_retries} retries — failing stop"
            )
            if attempt < max_retries and retry_delay_s:
                time.sleep(retry_delay_s)
    raise last_err


def render_resilient(
    scene,
    cam,
    base_key,
    spp: int | None = None,
    spp_batch: int | None = None,
    *,
    max_retries: int = 2,
    checkpoint_path: str | None = None,
    stats: RetryStats | None = None,
    log=None,
    **accumulate_kw,
) -> jnp.ndarray:
    """Full render with batch-grain elastic recovery -> [H, W, 3].

    Optionally persists each completed batch to `checkpoint_path`, so
    even a process-killing failure resumes from the last good batch on
    the next invocation (process-grain elasticity on top of the
    in-process batch retries).
    """
    import os

    spp = cam.samples_per_pixel if spp is None else spp
    spp_batch = spp_batch or max(1, spp // 10)

    if checkpoint_path and os.path.exists(checkpoint_path):
        state = ckpt.load(checkpoint_path)
        validate_state(state)
    else:
        state = ckpt.new_state(cam)

    while int(state.spp_done) < spp:
        n = min(spp_batch, spp - int(state.spp_done))
        state = accumulate_resilient(
            state, scene, cam, base_key, n,
            max_retries=max_retries, stats=stats, log=log, **accumulate_kw,
        )
        if checkpoint_path:
            ckpt.save(state, checkpoint_path)
    return state.image
