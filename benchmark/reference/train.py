"""The training step in plain PyTorch: the mean CTC loss over the feasible
examples plus the L2 term, the gradient by autograd, the global-norm clip,
Adam with the step-decay learning rate, then the moving BN statistics'
update from the step's batch statistics.

Written from the configuration's description (optax's ``clip_by_global_norm``
then ``adam``: the clip scales only at ``norm >= clip``, with no epsilon;
Adam's bias corrections at the update count starting from 1), independent
of the program.
"""

from __future__ import annotations

import torch

from . import ctc, model


def train_steps(state, batches, hp, prec=None, fault=None, moments=None,
                count0=0):
    """Run ``len(batches)`` steps from ``state`` (a dict of parameters and
    moving statistics, copied, not changed), with Adam's moments
    ``moments = (mu, nu)`` after ``count0`` updates (zeros and 0 for a
    fresh start).

    ``batches``: ``(image [N, W, H] uint8, label [N, L], label_len [N],
    time_step [N])`` device tensors. ``hp``: ``lr``, ``gamma``,
    ``stepsize``, ``weight_decay``, ``clip``, ``bn_momentum``. ``prec``:
    :func:`model.forward`'s. ``fault`` plants a fault for the benchmark's
    tests of its own comparison: ``'frozen'`` returns the state unchanged,
    ``'half'`` takes the mean over the first half of the batch only.

    Returns ``(losses [steps] list of floats, (mu, nu), state)``: Adam's
    moments after the last step and the parameters and statistics after
    it.
    """
    p = {k: v.detach().clone() for k, v in state.items()}
    names = [k for k in p if not model.is_buffer(k)]
    if moments is None:
        mu = {k: torch.zeros_like(p[k]) for k in names}
        nu = {k: torch.zeros_like(p[k]) for k in names}
    else:
        mu, nu = ({k: v[k].detach().clone() for k in names} for v in moments)
    b1, b2, eps = 0.9, 0.999, 1e-8
    losses = []
    for count, (image, label, label_len, t_step) in enumerate(batches,
                                                              count0):
        leaves = {k: p[k].requires_grad_(True) for k in names}
        params = dict(p, **leaves)
        bn_batch = {}
        logits = model.forward(params, image, t_step, prec=prec,
                               bn_collect=bn_batch)
        per = ctc.ctc_loss(logits.transpose(0, 1), label.long(), label_len,
                           t_step)
        feasible = per < 1e29
        if fault == 'half':
            feasible = feasible & (torch.arange(per.shape[0],
                                                device=per.device)
                                   < per.shape[0] // 2)
        mean = torch.where(feasible, per, torch.zeros_like(per)).sum() \
            / torch.clamp(feasible.sum(), min=1)
        total = mean + model.l2_loss(params, hp['weight_decay'])
        grads = torch.autograd.grad(total, [leaves[k] for k in names])
        losses.append(float(total.detach()))
        with torch.no_grad():
            for k in names:
                p[k] = p[k].detach()
            norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
            scale = torch.where(norm < hp['clip'], torch.ones_like(norm),
                                hp['clip'] / norm)
            grads = [g * scale for g in grads]
            lr = hp['lr'] * hp['gamma'] ** (count // hp['stepsize'])
            t = count + 1
            for k, g in zip(names, grads):
                mu[k] = b1 * mu[k] + (1 - b1) * g
                nu[k] = b2 * nu[k] + (1 - b2) * g * g
                if fault == 'frozen':
                    continue
                upd = (mu[k] / (1 - b1 ** t)) / (
                    torch.sqrt(nu[k] / (1 - b2 ** t)) + eps)
                p[k] = p[k] - lr * upd
            m = hp['bn_momentum']
            for name, (bm, bv) in bn_batch.items():
                if fault == 'frozen':
                    continue
                p[name + '.bn_mean'] = m * p[name + '.bn_mean'] + (1 - m) * bm
                p[name + '.bn_var'] = m * p[name + '.bn_var'] + (1 - m) * bv
    return losses, (mu, nu), {k: v.detach() for k, v in p.items()}
