"""Pack a pytree of small parameter arrays into ONE flat array.

Element descriptions are pytrees of ~50 tiny leaves (3-vectors, 3x3 poses,
scalars). Passing them to a jitted function transfers each leaf separately,
and each transfer has a fixed host cost that dwarfs the math. Packing makes
scene upload a single transfer; the unpack (slicing) happens inside jit and
is free.
"""

from __future__ import annotations

import math

import jax
import numpy as np


def pack_tree(tree):
    """Returns (flat float array, static meta) for a float-leaf pytree.

    Python-scalar leaves (surface radii, support dimensions — weakly-typed
    floats/ints/bools) are NOT packed: they travel in the static meta and
    are reinserted verbatim by :func:`unpack_tree`, staying weakly typed
    compile-time constants inside jit. Packing them as arrays would strong-
    type them (float64 under x64), silently promoting the whole trace."""
    leaves, treedef = jax.tree_util.tree_flatten(tree)
    specs = []
    arrs = []
    for leaf in leaves:
        # normalize NumPy scalars (np.float64 subclasses float but is
        # STRONGLY typed in jax — it would promote f32 math under x64)
        if isinstance(leaf, (bool, np.bool_)):
            specs.append(("const", bool(leaf)))
        elif isinstance(leaf, (float, np.floating)):
            specs.append(("const", float(leaf)))
        elif isinstance(leaf, (int, np.integer)):
            specs.append(("const", int(leaf)))
        else:
            a = np.asarray(leaf)
            specs.append((a.shape, str(a.dtype)))
            arrs.append(a)
    if arrs:
        dtype = np.result_type(*[a.dtype for a in arrs])
        flat = np.concatenate([a.ravel().astype(dtype) for a in arrs])
    else:
        flat = np.zeros((0,), dtype=np.float32)
    meta = (treedef, tuple(specs))
    return flat, meta


def unpack_tree(flat, meta):
    """Inverse of :func:`pack_tree`; usable on traced arrays inside jit."""
    treedef, specs = meta
    leaves = []
    i = 0
    for shape, dt in specs:
        if shape == "const":
            leaves.append(dt)  # weakly-typed python scalar, verbatim
            continue
        n = int(math.prod(shape))
        # canonicalize: float64 leaves degrade to float32 when x64 is off —
        # without this, astype(float64) on a non-x64 backend emits a
        # UserWarning on every driver run (and truncates anyway)
        dt = jax.dtypes.canonicalize_dtype(np.dtype(dt))
        leaves.append(flat[i : i + n].reshape(shape).astype(dt))
        i += n
    return jax.tree_util.tree_unflatten(treedef, leaves)
