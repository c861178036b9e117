"""The local store of pretrained weights (counterpart of
``mxnet_tpu.gluon.model_zoo.model_store``).

A zoo factory with ``pretrained=True`` loads ``{name}.params`` (or the
reference's download naming, ``{name}-{sha1[:8]}.params``) from the
store's root: ``root``, else ``models`` under the ``model_store.root``
knob (``MXNET_HOME``; ``~/.mxnet/models`` by default).  Nothing is
downloaded: the file is put there by hand.  Of several hashed files of
one name the lexicographically first is taken, as the reference does.
"""
from __future__ import annotations

import os

__all__ = ["get_model_file", "purge", "load_pretrained"]


def _root(root=None):
    if root is None:
        from ... import config
        base = config.get("model_store.root") or \
            os.path.join(os.path.expanduser("~"), ".mxnet")
        root = os.path.join(base, "models")
    return os.path.expanduser(root)


def get_model_file(name, root=None):
    """The path of ``name``'s parameter file in the store."""
    root = _root(root)
    exact = os.path.join(root, "%s.params" % name)
    if os.path.exists(exact):
        return exact
    if os.path.isdir(root):
        hashed = sorted(f for f in os.listdir(root)
                        if f.startswith("%s-" % name)
                        and f.endswith(".params"))
        if hashed:
            return os.path.join(root, hashed[0])
    raise RuntimeError(
        "Pretrained weights for %r not found under %s, and this host has "
        "no network: put %s.params there (either package's "
        "save_parameters file)." % (name, root, name))


def purge(root=None):
    """Delete every parameter file of the store."""
    root = _root(root)
    if not os.path.isdir(root):
        return
    for f in os.listdir(root):
        if f.endswith(".params"):
            os.remove(os.path.join(root, f))


def load_pretrained(net, name, root=None, ctx=None):
    """Load the store's ``name`` into ``net`` (``load_parameters``)."""
    net.load_parameters(get_model_file(name, root), ctx=ctx)
    return net
