"""The reference's compressed DCN step, rebuilt from the reference's own
codec and gradients, for tests/test_torch_dist.py and
tests/test_torch_compression.py."""
import jax
import numpy as np

import mxnet_tpu as ref
import mxnet_tpu.name  # noqa: F401

import torch_dist_worker as W


def _strip(name):
    return name.split("_", 1)[1]


def dcn_inputs(n):
    """The compressed step's batches and initial weights (exact and
    random), keyed as tests/torch_dist_worker.py reads them."""
    out = {}
    for exact in (True, False):
        pre = "dcn_exact/" if exact else "dcn_random/"
        xs, ys, init = W.dcn_batches(n, exact)
        for s in range(W.STEPS):
            out[pre + "x%d" % s], out[pre + "y%d" % s] = xs[s], ys[s]
        with ref.name.NameManager():
            dnet = W.dcn_net(ref)
        for name in dnet.collect_params():
            out[pre + "init/" + name] = init[name.rsplit("_", 1)[1]]
    return out


def ref_dcn(n, inputs, exact):
    """The reference's compressed DCN step (``parallel/trainer.py:397-420``)
    on ``{"dcn": n}``, rebuilt from the reference's own pieces: each
    shard's gradient of its rows' mean loss (``jax.grad`` through the
    reference's functionalized Block and loss), divided by the shard
    count, coded by the reference's ``two_bit_compress`` against the
    shard's residual, packed and unpacked by ``pack_2bit`` /
    ``unpack_2bit`` and summed over the shards; then the reference's SGD
    step.  The reference's fused program itself does not trace under this
    JAX (shard_map's replication check rejects its out_specs; its own
    tests/test_elastic.py compressed-step tests are red for that)."""
    import jax.numpy as jnp
    from mxnet_tpu.parallel import compression as rc
    from mxnet_tpu.parallel import functionalize
    from mxnet_tpu.parallel.trainer import _as_scalar_loss
    pre = "dcn_exact/" if exact else "dcn_random/"
    with ref.name.NameManager():
        net = W.dcn_net(ref)
    net.initialize()
    for name, p in net.collect_params().items():
        p.set_data(ref.nd.array(inputs[pre + "init/" + name]))
    fn = functionalize(net)
    params = {k: jnp.asarray(v) for k, v in fn.init_values().items()}
    loss_fn = ref.gluon.loss.L2Loss()
    opt = ref.optimizer.create("sgd", learning_rate=W.DCN_LR)

    def loss_of(train, x, y):
        (out,), _ = fn.apply(train, (x,), jax.random.PRNGKey(0),
                             training=True)
        return _as_scalar_loss(loss_fn, out, y)
    grad_of = jax.jit(jax.value_and_grad(loss_of))
    res = {k: [jnp.zeros_like(v) for _ in range(n)]
           for k, v in params.items()}
    out = {}
    for s in range(W.STEPS):
        x, y = inputs[pre + "x%d" % s], inputs[pre + "y%d" % s]
        b = x.shape[0] // n
        shards = [grad_of(params, x[k * b:(k + 1) * b], y[k * b:(k + 1) * b])
                  for k in range(n)]
        loss = shards[0][0]
        for k in range(1, n):
            loss = loss + shards[k][0]
        out["loss%d" % s] = np.asarray(loss / n)
        for name, w in params.items():
            tot = jnp.zeros((int(w.size),), jnp.int32)
            for k in range(n):
                codes, res[name][k] = rc.two_bit_compress(
                    shards[k][1][name] / n, res[name][k], W.DCN_THRESHOLD)
                tot = tot + rc.unpack_2bit(rc.pack_2bit(codes), int(w.size))
            g = (tot.astype(w.dtype) * W.DCN_THRESHOLD).reshape(w.shape)
            params[name], _ = opt.step(w, g, None, np.float32(W.DCN_LR),
                                       np.float32(0.0), s + 1)
            out["res%d/%s" % (s, _strip(name))] = np.stack(
                [np.asarray(r) for r in res[name]])
    for name, w in params.items():
        out["param/" + _strip(name)] = np.asarray(w)
    return out
