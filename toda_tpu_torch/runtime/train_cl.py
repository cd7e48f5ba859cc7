"""The stage-2 two-view (adv, org) train step with the consistency loss.

Counterpart of ``toda_tpu/runtime/train_cl.py`` (``select_cl_arrays``,
``make_train_step_cl`` :16-62). One call: the adv view's forward in
training mode, then the org view's (BatchNorm running statistics updated by
the adv batch, then by the org batch, as JAX threads them), both detection
losses, each view's top-K decoded boxes mapped back to the scene's frame,
the consistency loss, one backward through the sum and one AdamW update. A
data-parallel run reduces as ``train_utils.make_train_step`` does.
"""

from ..models.consistency import consistency_loss, reverse_boxes
from ..parallel.mesh import allreduce_grads, sum_scalars

CL_ARRAY_KEYS = ("points", "points_mask", "gt_boxes", "aug_vector")


def select_cl_arrays(batch):
    """Each view's static-shape arrays of a ``CLPairDataset`` batch."""
    return {view: {k: v for k, v in batch[view].items() if k in CL_ARRAY_KEYS}
            for view in ("adv", "org")}


def make_train_step_cl(bundle, consistency_weight=0.1, score_thresh=0.3, topk=32):
    """train_step(state, batch) -> (state, tb): one optimizer step on a
    dual batch (numpy or tensors; see ``select_cl_arrays``). tb holds the
    total, both detection losses and the two consistency terms as device
    tensors; the step never waits for the device."""

    def train_step(state, batch):
        arrays = select_cl_arrays(batch)
        adv, org = bundle.to_device(arrays["adv"]), bundle.to_device(arrays["org"])
        for p in state.params:
            p.grad = None
        bundle.module.train()
        out_a = bundle.module(adv)
        out_o = bundle.module(org)
        loss_a, _ = bundle.head_loss(out_a, adv["gt_boxes"])
        loss_o, _ = bundle.head_loss(out_o, org["gt_boxes"])
        boxes_a, scores_a = bundle.decode_topk(out_a, k=topk)
        boxes_o, scores_o = bundle.decode_topk(out_o, k=topk)
        c_loss, s_loss = consistency_loss(
            reverse_boxes(boxes_a, adv["aug_vector"]), scores_a,
            reverse_boxes(boxes_o, org["aug_vector"]), scores_o, score_thresh=score_thresh)
        total = loss_a + loss_o + consistency_weight * (c_loss + s_loss)
        total.backward()
        allreduce_grads(state.params)
        state.step()
        tb = {"loss": total, "loss_adv": loss_a, "loss_org": loss_o,
              "consistency_center": c_loss, "consistency_size": s_loss}
        return state, sum_scalars({k: v.detach() for k, v in tb.items()})

    return train_step
