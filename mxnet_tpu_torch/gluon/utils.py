"""Gluon utilities (counterpart of ``mxnet_tpu.gluon.utils``): batch
splitting across contexts, ``clip_global_norm``, file hashes and
``download``.

``download`` keeps the reference's signature.  It reads ``file://`` URLs
and returns a file already present (with a matching hash when one is
given); any other URL raises with the path to stage the file at, since
the hosts this package targets have no network.
"""
from __future__ import annotations

import hashlib
import os
import shutil
import warnings

import torch

from ..ndarray.ndarray import NDArray, array as nd_array

__all__ = ["split_data", "split_and_load", "clip_global_norm", "check_sha1",
           "download", "shape_is_known"]


def split_data(data, num_slice, batch_axis=0, even_split=True):
    """``num_slice`` slices of ``data`` along ``batch_axis`` (reference
    ``gluon/utils.py:36``); the last takes the remainder."""
    size = data.shape[batch_axis]
    if even_split and size % num_slice != 0:
        raise ValueError(
            "data with shape %s cannot be evenly split into %d slices "
            "along axis %d. Use a batch size that's multiple of %d or set "
            "even_split=False to allow uneven partitioning of data." % (
                str(data.shape), num_slice, batch_axis, num_slice))
    if num_slice == 1:
        return [data]
    step = size // num_slice
    if not even_split and size < num_slice:
        step = 1
        num_slice = size
    slices = []
    for i in range(num_slice):
        begin = i * step
        end = (i + 1) * step if i < num_slice - 1 else size
        slices.append(data.slice_axis(batch_axis, begin, end))
    return slices


def split_and_load(data, ctx_list, batch_axis=0, even_split=True):
    """One slice of ``data`` on each context of ``ctx_list`` (reference
    ``gluon/utils.py:85``)."""
    if not isinstance(data, NDArray):
        data = nd_array(data, ctx=ctx_list[0])
    if len(ctx_list) == 1:
        return [data.as_in_context(ctx_list[0])]
    slices = split_data(data, len(ctx_list), batch_axis, even_split)
    return [i.as_in_context(ctx) for i, ctx in zip(slices, ctx_list)]


def clip_global_norm(arrays, max_norm, check_isfinite=True):
    """Scale ``arrays`` in place so that their joint 2-norm is at most
    ``max_norm``; returns that norm, a float (a synchronising read) with
    ``check_isfinite``, else a 0-d tensor (reference
    ``gluon/utils.py:115``)."""
    assert len(arrays) > 0
    device = arrays[0]._data.device
    total_norm = torch.sqrt(sum(
        torch.sum(torch.square(arr._data.reshape(-1))).to(device)
        for arr in arrays))
    if check_isfinite:
        tn = float(total_norm)
        if not (tn == tn and abs(tn) != float("inf")):
            warnings.warn(UserWarning("nan or inf is detected. Clipping "
                                      "results will be undefined."),
                          stacklevel=2)
    scale = torch.clamp(max_norm / (total_norm + 1e-8), max=1.0)
    for arr in arrays:
        arr._set_data(arr._data * scale.to(arr._data.device,
                                           arr._data.dtype))
    if check_isfinite:
        return tn
    return total_norm


def check_sha1(filename, sha1_hash):
    """Whether the file's SHA-1 is ``sha1_hash`` (reference
    ``gluon/utils.py:165``)."""
    sha1 = hashlib.sha1()
    with open(filename, "rb") as f:
        while True:
            data = f.read(1048576)
            if not data:
                break
            sha1.update(data)
    return sha1.hexdigest() == sha1_hash


def download(url, path=None, overwrite=False, sha1_hash=None, retries=5,
             verify_ssl=True):
    """The local path of ``url``'s file (reference
    ``gluon/utils.py:190``): a present file (hash checked) is returned, a
    ``file://`` URL is copied there; any other URL raises."""
    fname = url.split("/")[-1] if path is None else path
    if path is not None and os.path.isdir(path):
        fname = os.path.join(path, url.split("/")[-1])
    if os.path.exists(fname) and not overwrite and (
            sha1_hash is None or check_sha1(fname, sha1_hash)):
        return fname
    if url.startswith("file://"):
        dirname = os.path.dirname(os.path.abspath(os.path.expanduser(fname)))
        os.makedirs(dirname, exist_ok=True)
        shutil.copyfile(url[len("file://"):], fname)
        if sha1_hash and not check_sha1(fname, sha1_hash):
            raise UserWarning(
                "File {} is downloaded but the content hash does not match."
                " The repo may be outdated or download may be incomplete. "
                "If the \"repo_url\" is overridden, consider switching to "
                "the default repo.".format(fname))
        return fname
    raise RuntimeError(
        "download(%s) unavailable: this host has no network. Stage the "
        "file at %r." % (url, fname))


def shape_is_known(shape):
    """Whether every dimension of ``shape`` is known (not 0; reference
    ``gluon/utils.py:413``)."""
    if shape is None:
        return False
    if len(shape) == 0:
        return True
    for dim_size in shape:
        if dim_size == 0:
            return False
        assert dim_size > 0, "shape dimension size cannot be less than " \
            "0, while received {}".format(dim_size)
    return True
