"""Packed tables and the scene tensors they were packed from.

The kernels read a scene through tables packed from its tensors:
``brute_intersect.brute_table`` (the brute intersection),
``megakernel.kernel_tables`` (the bounce megakernel) and
``mesh_megakernel.mesh_tables`` (the mesh megakernel).  The builder packs
them once and stores them in the scene; each also keeps a ``key``: the
tensors it was packed from and the ``_version`` each had then.  A launch
reads the stored tables only while ``holds(key, sources)``, every source
the same tensor object, written nowhere since; otherwise it packs them
again from the scene it was given.  So a scene made with ``_replace``
(the gradient idiom of the reference, ``tests/test_grad.py``) or edited in
place reads its own tables, and a scene as built packs nothing a launch.
Comparing identities and version counters reads nothing from the device.

``float_sources`` and ``replace_sources`` list a scene's float source
tensors and put others in their places: the kernels' ``autograd.Function``
(``megakernel.replayed``) passes them to ``apply`` so that a gradient
reaches them.
"""

from __future__ import annotations

import torch


def tensors(*groups) -> tuple:
    """The tensors of ``groups`` (tensors, or NamedTuples of them, whose
    other fields are skipped), in field order."""
    out = []
    for g in groups:
        if torch.is_tensor(g):
            out.append(g)
        else:
            out.extend(v for v in g if torch.is_tensor(v))
    return tuple(out)


def key(sources: tuple) -> tuple:
    """The key of tables packed from ``sources`` now."""
    return tuple((s, s._version) for s in sources)


def holds(k: tuple, sources: tuple) -> bool:
    """Whether tables keyed ``k`` were packed from exactly ``sources``: the
    same tensor objects, none written since."""
    return len(k) == len(sources) and all(
        t is s and t._version == v for (t, v), s in zip(k, sources))


# the scene's tables of source tensors; its other NamedTuple fields (the
# packed tables, the BVH, the static infos) are made from them
SOURCE_GROUPS = ("prims", "materials", "textures", "lights")


def float_sources(scene) -> list:
    """[((group, field), tensor)] of the scene's float source tensors, in
    field order: those of SOURCE_GROUPS (group None: the scene's own)."""
    out = []
    for name, v in zip(scene._fields, scene):
        if name in SOURCE_GROUPS:
            out += [((name, f), t) for f, t in zip(v._fields, v)
                    if torch.is_tensor(t) and t.is_floating_point()]
        elif torch.is_tensor(v) and v.is_floating_point():
            out.append(((None, name), v))
    return out


def replace_sources(scene, paths, values):
    """The scene with the tensors at ``paths`` (as ``float_sources`` names
    them) replaced by ``values``, by ``_replace``."""
    top, groups = {}, {}
    for (group, name), v in zip(paths, values):
        if group is None:
            top[name] = v
        else:
            groups.setdefault(group, {})[name] = v
    return scene._replace(**top, **{g: getattr(scene, g)._replace(**kw)
                                     for g, kw in groups.items()})

