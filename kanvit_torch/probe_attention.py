"""Accuracy of the lanes attention kernels against f64, on the card.

    python -m kanvit_torch.probe_attention

First the lanes attention at three geometries the ViT paths run (the card's
train-step test's: batch 6, T 50, 2 heads of 32; vit-s; MNIST at dh 8),
the kernels and, beside them, the plain version in f32 on the card: for the
output and each of dq, dk, dv, the largest and the rms error against f64
computed on the card, over the f64 tensor's max|.|, and how many elements
lie more than 1% of their own f64 value away. Then the models of
``tests/test_torch_port_cuda.py::test_variant_train_step_on_card``, two Adam
steps on the card and on the CPU: at each step, how many parameter
gradients the card and the CPU give more than 1% apart, how many of each
side's lie more than 1% from f64 (an f64 copy of the CPU model), and the
worst tensor's max error over its max|g| on each side; after the steps, the
parameters more than 1e-4 apart.

To compare another tree's kernels, copy this file into that tree's
``kanvit_torch/`` and run it from that tree's root.
"""

import copy

import numpy as np
import torch
import torch.nn.functional as F

GEOMETRIES = (("train-step test", 6, 50, 2, 32), ("vit-s", 64, 197, 6, 64),
              ("mnist dh 8", 64, 50, 8, 8))
VARIANTS = ("cheby", "fourier", "vanilla", "fast", "sine")


def errors(got, want):
    """Largest and rms error over max|want|, and the count of elements more
    than 1% of their own reference value away."""
    d = got.double() - want
    scale = float(want.abs().max())
    return (float(d.abs().max()) / scale, float(d.pow(2).mean().sqrt()) / scale,
            int((d.abs() > 1e-2 * want.abs()).sum()))


def attention_errors(seed=0):
    from kanvit_torch.kernels import flash_attention as FA
    from kanvit_torch.ops import attention as A

    rng = np.random.default_rng(seed)
    for label, b, t, h, dh in GEOMETRIES:
        y = torch.from_numpy(rng.standard_normal((b * t, h * 3 * dh))
                             .astype(np.float32)).cuda()
        g = torch.from_numpy(rng.standard_normal((b, t, h * dh))
                             .astype(np.float32)).cuda()

        def run(attn, y):
            y = y.detach().requires_grad_(True)
            y4 = y.view(b, t, h, 3 * dh)
            o = attn(*(y4[..., i * dh:(i + 1) * dh] for i in range(3)), h)
            (gy,) = torch.autograd.grad(o, y, g.to(o.dtype))
            return o.detach(), gy.view(b, t, h, 3, dh)

        o64, g64 = run(A.lanes_attention, y.double())
        for name, attn in (("kernels", FA.flash_attention_lanes),
                           ("plain f32", A.lanes_attention)):
            o, gy = run(attn, y)
            parts = [("o", o, o64)] + [(f"d{c}", gy[..., i, :], g64[..., i, :])
                                       for i, c in enumerate("qkv")]
            print(f"[attention] {label} (B {b}, T {t}, H {h}, dh {dh}), {name}: "
                  + "; ".join("{} max {:.3e} rms {:.3e} >1% {}".format(p, *errors(a, w))
                              for p, a, w in parts), flush=True)


def train_step_gradients():
    from kanvit_torch.models import create_model
    from kanvit_torch.train import create_train_state, make_train_step

    for variant in VARIANTS:
        cpu = create_model(variant, chw=(1, 28, 28), n_patches=7, n_blocks=2,
                           d_hidden=64, n_heads=2, out_d=10, seed=3)
        gpu = copy.deepcopy(cpu).cuda()
        rng = np.random.default_rng(64)
        x = torch.from_numpy(rng.standard_normal((6, 1, 28, 28)).astype(np.float32))
        y = torch.from_numpy(rng.integers(0, 10, 6))
        step = make_train_step()
        sc, sg = create_train_state(cpu), create_train_state(gpu)
        for t in (1, 2):
            exact = copy.deepcopy(cpu).double()
            exact.zero_grad(set_to_none=True)
            F.cross_entropy(exact(x.double()), y).backward()
            sc, _, _ = step(sc, x, y)
            sg, _, _ = step(sg, x.cuda(), y.cuda())
            apart = cpu_far = gpu_far = 0
            cpu_worst = gpu_worst = 0.0
            # a tensor whose f64 max|g| is at f32 rounding level of the
            # model's largest (a key bias: 0 in exact arithmetic) is
            # measured against the largest
            top = max(float(p.grad.abs().max()) for p in exact.parameters())
            for pc, pg, pe in zip(cpu.parameters(), gpu.parameters(), exact.parameters()):
                gc, gg, ge = pc.grad.double(), pg.grad.double().cpu(), pe.grad
                apart += int(((gc - gg).abs() > 1e-2 * gc.abs()).sum())
                cpu_far += int(((gc - ge).abs() > 1e-2 * ge.abs()).sum())
                gpu_far += int(((gg - ge).abs() > 1e-2 * ge.abs()).sum())
                scale = max(float(ge.abs().max()), 2.0 ** -24 * top)
                cpu_worst = max(cpu_worst, float((gc - ge).abs().max()) / scale)
                gpu_worst = max(gpu_worst, float((gg - ge).abs().max()) / scale)
            print(f"[train step] {variant} step {t}: gradients >1% apart card/CPU "
                  f"{apart}; >1% from f64: CPU {cpu_far}, card {gpu_far}; worst "
                  f"tensor max|err|/max|g| against f64: CPU {cpu_worst:.3e}, card "
                  f"{gpu_worst:.3e}", flush=True)
        far = {name: int(((pc - pg.cpu()).abs() > 1e-4).sum())
               for (name, pc), pg in zip(cpu.named_parameters(), gpu.parameters())}
        print(f"[train step] {variant}: parameters >1e-4 apart after two steps "
              f"{ {k: n for k, n in far.items() if n} }", flush=True)


def main():
    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU with CUDA")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    attention_errors()
    train_step_gradients()


if __name__ == "__main__":
    main()
