"""Checkpointing (orbax) + the reference's bbox-weight baking trick.

Reference equivalent (SURVEY.md §5.4): Caffe ``.caffemodel``/``.solverstate``
snapshots every SNAPSHOT_ITERS, where ``SolverWrapper.snapshot`` bakes the
bbox-target normalization mean/std back into the regression layer's weights
so inference needs no normalization metadata. We store (params, opt_state,
step) via orbax with auto-resume from latest, and provide
``bake_bbox_normalization`` / ``unbake_bbox_normalization`` implementing the
same trick for our dense heads (kernel columns scaled by std, bias
``b*std + mean`` tiled per 4-group).
"""

from __future__ import annotations

import os
from typing import Any, Optional, Tuple

import numpy as np

import jax
import jax.numpy as jnp


# ---------------------------------------------------------------------------
# Normalization baking (pure pytree surgery, framework-agnostic)
# ---------------------------------------------------------------------------


def flatten_dict(tree, prefix: tuple = ()) -> dict:
    """Nested dicts -> ``{path tuple: leaf}``."""
    flat = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            flat.update(flatten_dict(v, prefix + (k,)))
        else:
            flat[prefix + (k,)] = v
    return flat


def unflatten_dict(flat: dict) -> dict:
    """Inverse of :func:`flatten_dict`."""
    tree: dict = {}
    for path, leaf in flat.items():
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf
    return tree


def _map_head(params: Any, head_name: str, fn):
    """Apply fn(kernel, bias) -> (kernel, bias) to the named dense head."""
    flat = flatten_dict(params)
    hits = [k for k in flat if head_name in k and k[-1] == "kernel"]
    if not hits:
        raise KeyError(f"no dense head named {head_name!r} in params")
    for kk in hits:
        bk = kk[:-1] + ("bias",)
        flat[kk], flat[bk] = fn(flat[kk], flat[bk])
    return unflatten_dict(flat)


def bake_bbox_normalization(params: Any, means, stds, head_name: str = "adj_bbox"):
    """W' = W * std (per output column), b' = b * std + mean.

    means/stds are per-coordinate (4,) and get tiled across the head's 4K/4C
    outputs — after baking, raw head outputs ARE unnormalized deltas
    (the reference's snapshot-time convention).
    """
    means = np.asarray(means, np.float32)
    stds = np.asarray(stds, np.float32)

    def fn(kernel, bias):
        reps = bias.shape[-1] // 4
        t_std = jnp.asarray(np.tile(stds, reps))
        t_mean = jnp.asarray(np.tile(means, reps))
        return kernel * t_std[None, :], bias * t_std + t_mean

    return _map_head(params, head_name, fn)


def unbake_bbox_normalization(params: Any, means, stds, head_name: str = "adj_bbox"):
    """Inverse of :func:`bake_bbox_normalization` (resume training)."""
    means = np.asarray(means, np.float32)
    stds = np.asarray(stds, np.float32)

    def fn(kernel, bias):
        reps = bias.shape[-1] // 4
        t_std = jnp.asarray(np.tile(stds, reps))
        t_mean = jnp.asarray(np.tile(means, reps))
        return kernel / t_std[None, :], (bias - t_mean) / t_std

    return _map_head(params, head_name, fn)


# ---------------------------------------------------------------------------
# Orbax snapshot/restore
# ---------------------------------------------------------------------------


class Checkpointer:
    """Snapshot/restore of train state, reference ``SolverWrapper`` role."""

    def __init__(self, directory: str, prefix: str = "aznet"):
        self.directory = os.path.abspath(directory)
        self.prefix = prefix
        os.makedirs(self.directory, exist_ok=True)
        try:
            import orbax.checkpoint as ocp
        except ImportError as e:
            raise ImportError(
                "training snapshots need orbax-checkpoint "
                "(pip install orbax-checkpoint)") from e

        self._ocp = ocp
        self._mgr = ocp.CheckpointManager(
            self.directory,
            options=ocp.CheckpointManagerOptions(max_to_keep=5, create=True),
        )

    def save(self, step: int, state: Any) -> None:
        if step in (self._mgr.all_steps() or []):
            # Idempotent re-save (e.g. rerunning a finished training job):
            # orbax would raise StepAlreadyExistsError.
            print(f"[checkpoint] step {step} already exists in "
                  f"{self.directory}; skipping save")
            return
        self._mgr.save(step, args=self._ocp.args.StandardSave(state))
        self._mgr.wait_until_finished()

    def latest_step(self) -> Optional[int]:
        return self._mgr.latest_step()

    def restore(self, state_template: Any, step: Optional[int] = None) -> Tuple[Any, int]:
        """Restore into the template's structure (which may be a sub-tree of
        what was saved, e.g. params-only from a params+opt_state snapshot).
        Returns (state, step)."""
        step = step if step is not None else self._mgr.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.directory}")
        # Decide the restore path from the SAVED structure (item_metadata)
        # rather than by catching orbax errors — error types/messages drift
        # across versions, structure comparison does not.
        if self._is_subtree(state_template, self._stored_tree(step)):
            # Template is a strict sub-tree of what was saved (e.g.
            # params-only from a params+opt_state snapshot): restore the full
            # stored tree and select the requested keys.
            full = self._mgr.restore(step)

            def select(tmpl, stored):
                if isinstance(tmpl, dict):
                    return {k: select(v, stored[k]) for k, v in tmpl.items()}
                return stored

            restored = select(state_template, full)
        else:
            restored = self._mgr.restore(
                step, args=self._ocp.args.StandardRestore(state_template)
            )
        return restored, step

    def _stored_tree(self, step: int):
        """The saved pytree's structure (nested dicts of leaf metadata)."""
        md = self._mgr.item_metadata(step)
        return getattr(md, "tree", md)

    @staticmethod
    def _is_subtree(tmpl, stored) -> bool:
        """True iff ``tmpl``'s dict structure is a STRICT sub-tree of
        ``stored`` (fewer keys somewhere along a matching prefix)."""
        if not isinstance(tmpl, dict) or not isinstance(stored, dict):
            return False
        keys_t, keys_s = set(tmpl.keys()), set(stored.keys())
        if not keys_t <= keys_s:
            return False  # mismatched template: let StandardRestore report it
        if keys_t < keys_s:
            return True
        return any(Checkpointer._is_subtree(tmpl[k], stored[k]) for k in keys_t)
