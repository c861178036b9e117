"""SSD — the single-shot object detector (counterpart of
``mxnet_tpu.models.ssd``; BASELINE.json config 4, reference
``example/ssd/symbol/``).

A small conv trunk, extra downsampling stages, per-scale class and box
convolution heads and ``MultiBoxPrior`` anchors, as a Gluon
``HybridBlock`` with the reference's parameter names.  Training targets
come from ``MultiBoxTarget`` (3:1 hard-negative mining) and inference
from softmax and ``MultiBoxDetection``, whose per-class NMS is the
hand-written kernel of ``csrc/box_nms.cu`` on the card
(``kernels.box_nms``).
"""
from __future__ import annotations

from ..gluon import nn, HybridBlock
from ..ops.registry import invoke

__all__ = ["SSD", "ssd_512", "MultiBoxLoss"]


def _conv_block(channels, stride=1):
    blk = nn.HybridSequential()
    blk.add(nn.Conv2D(channels, kernel_size=3, strides=stride, padding=1),
            nn.BatchNorm(), nn.Activation("relu"))
    return blk


class SSD(HybridBlock):
    """Multi-scale SSD head over a small conv trunk.

    ``num_classes`` excludes the background; at each scale the class head
    predicts ``num_classes + 1`` scores and the box head 4 offsets an
    anchor.  The stem halves the input twice, the first stage keeps its
    size and each later stage halves it again."""

    def __init__(self, num_classes, num_scales=4, base_channels=32,
                 sizes=None, ratios=None, **kwargs):
        super().__init__(**kwargs)
        self.num_classes = num_classes
        self._sizes = sizes or [(0.2 + 0.15 * i,) for i in range(num_scales)]
        self._ratios = ratios or [(1.0, 2.0, 0.5)] * num_scales
        self._anchors_per = [len(s) + len(r) - 1
                             for s, r in zip(self._sizes, self._ratios)]
        with self.name_scope():
            self.stem = nn.HybridSequential()
            self.stem.add(_conv_block(base_channels, 2),
                          _conv_block(base_channels * 2, 2))
            self.stages = []
            self.cls_heads = []
            self.box_heads = []
            for i in range(num_scales):
                stage = _conv_block(base_channels * 2, stride=2 if i else 1)
                cls = nn.Conv2D(self._anchors_per[i] * (num_classes + 1),
                                kernel_size=3, padding=1)
                box = nn.Conv2D(self._anchors_per[i] * 4, kernel_size=3,
                                padding=1)
                self.register_child(stage, "stage%d" % i)
                self.register_child(cls, "cls%d" % i)
                self.register_child(box, "box%d" % i)
                self.stages.append(stage)
                self.cls_heads.append(cls)
                self.box_heads.append(box)

    def hybrid_forward(self, F, x):
        """-> (anchors (1, N, 4), cls_preds (B, N, C+1), box_preds (B,
        N*4))."""
        x = self.stem(x)
        anchors, cls_out, box_out = [], [], []
        for i, stage in enumerate(self.stages):
            x = stage(x)
            anchors.append(F.MultiBoxPrior(x, sizes=self._sizes[i],
                                           ratios=self._ratios[i]))
            c = self.cls_heads[i](x)        # (B, A*(C+1), H, W)
            b = self.box_heads[i](x)        # (B, A*4, H, W)
            cls_out.append(
                c.transpose((0, 2, 3, 1)).reshape(
                    (c.shape[0], -1, self.num_classes + 1)))
            box_out.append(
                b.transpose((0, 2, 3, 1)).reshape((b.shape[0], -1)))
        return (F.concat(*anchors, dim=1),
                F.concat(*cls_out, dim=1),
                F.concat(*box_out, dim=1))

    def targets(self, anchors, cls_preds, labels):
        """Training targets ``(box_target, box_mask, cls_target)`` through
        ``MultiBoxTarget`` (``cls_preds`` transposed to its (B, C+1, N)
        layout) with SSD's 3:1 hard-negative mining."""
        return invoke("MultiBoxTarget", anchors,
                      labels, cls_preds.transpose((0, 2, 1)),
                      negative_mining_ratio=3.0,
                      negative_mining_thresh=0.5)

    def detect(self, anchors, cls_preds, box_preds, nms_threshold=0.45,
               threshold=0.01):
        """Detections (B, N, 6) through softmax and ``MultiBoxDetection``
        (rows [class_id, score, x1, y1, x2, y2], suppressed rows class id
        -1)."""
        probs = invoke("softmax", cls_preds, axis=-1)
        return invoke("MultiBoxDetection", probs.transpose((0, 2, 1)),
                      box_preds, anchors, nms_threshold=nms_threshold,
                      threshold=threshold)


def ssd_512(num_classes=20, **kwargs):
    """The SSD-512 configuration: 4 scales over a 32-channel trunk, 65,280
    anchors at a 512x512 input."""
    return SSD(num_classes, num_scales=4, base_channels=32, **kwargs)


class MultiBoxLoss:
    """SSD's training loss: softmax cross entropy over the mined classes
    plus smooth-L1 over the matched boxes, each over its own count (the
    reference's ``MultiBoxLoss``).  Built from ``mx.nd`` ops, so it lands
    on the autograd tape; the targets enter as constants."""

    def __call__(self, cls_preds, box_preds, cls_target, box_target,
                 box_mask):
        from .. import nd
        keep = nd.cast(cls_target >= 0, dtype="float32")  # ignore = -1
        logp = nd.log_softmax(cls_preds, axis=-1)
        gold = nd.pick(logp, nd.maximum(cls_target, nd.zeros_like(
            cls_target)), axis=-1)
        one = nd.ones_like(keep.sum())
        cls_loss = -(gold * keep).sum() / nd.maximum(keep.sum(), one)
        diff = nd.abs((box_preds - box_target) * box_mask)
        sl1 = nd.where(diff < 1.0, 0.5 * diff * diff, diff - 0.5)
        box_loss = sl1.sum() / nd.maximum(box_mask.sum(), one)
        return cls_loss + box_loss
