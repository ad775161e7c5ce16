"""DPMM image-compression demo on the PyTorch/CUDA port: the twin of
main.py (reference examples/mixture/main.py:28-377).

Takes 2-D points drawn from an image's intensity distribution, fits a
Pitman-Yor x (NICH, NICH) DPMM with five inference strategies, and
re-synthesizes the image from the learned predictive density:

  sequential  — greedy posterior-predictive assignment (one pass)
  gibbs       — prior init + blocked collapsed-Gibbs passes
  seq-gibbs   — sequential init + blocked collapsed-Gibbs passes
  annealing   — subsample annealing
  smc         — SMC particle-filter init (no reference analog)

The points are the tracked data/samples.json.gz (10,000 rows, the ones
main.py wrote); asking for more draws new ones from the image with a
`torch.Generator` seeded by --seed, and writes nothing into data/.  Images
go to results_torch/ (or --out), never over the tracked results/.  The
model and the strategies run on the card, or on the CPU with --cpu.

Usage (from the repository's root):
  PYTHONPATH=. python examples/mixture/main_torch.py run [--samples 10000]
  PYTHONPATH=. python examples/mixture/main_torch.py gibbs [--cpu] [--out DIR]
"""

import argparse
import os
import time

import numpy as np
import torch

from distributions_tpu_torch import clustering, config, mixture as mx
from distributions_tpu_torch.inference import annealing as annealing_mod
from distributions_tpu_torch.inference import smc as smc_mod
from distributions_tpu_torch.io.stream import json_stream_load
from distributions_tpu_torch.models import nich
from distributions_tpu_torch.ops import gibbs as gibbs_ops
from distributions_tpu_torch.random import sample_discrete, sample_from_scores

ROOT = os.path.dirname(os.path.abspath(__file__))
DATA = os.path.join(ROOT, 'data')
RESULTS = os.path.join(ROOT, 'results_torch')
SAMPLES = os.path.join(DATA, 'samples.json.gz')

SAMPLE_COUNT = 10000
PASSES = 10
EMPTY_GROUP_COUNT = 10  # reference main.py:51
CAPACITY = 768
BLOCK = 500


def default_image(width=64, height=64):
    """Synthetic stand-in for the reference's fox.png (not shipped): a few
    gaussian blobs rendered to a grayscale intensity array (main.py's)."""
    yy, xx = np.mgrid[0:width, 0:height].astype(np.float64)
    img = np.zeros((width, height))
    rng = np.random.RandomState(0)
    for _ in range(6):
        cx, cy = rng.rand(2) * [width, height]
        sx, sy = 3 + 8 * rng.rand(2)
        img += np.exp(-((xx - cy) ** 2 / (2 * sy ** 2)
                        + (yy - cx) ** 2 / (2 * sx ** 2)))
    img = 255 * (1.0 - img / img.max())
    return img.astype(np.uint8)


def load_image():
    try:
        from PIL import Image  # optional
        path = os.path.join(ROOT, 'fox.png')
        if os.path.exists(path):
            return np.asarray(Image.open(path).convert('L'))
    except ImportError:
        pass
    return default_image()


class ImageModel(object):
    """reference main.py:59-70, on `device` (default: the port's)."""

    def __init__(self, device=None):
        self.clustering = clustering.PitmanYor.from_dict(
            {'alpha': 100.0, 'd': 0.1}, device=device)
        self.feature = nich.shared_from_dict(
            {'mu': 0.0, 'kappa': 0.1, 'sigmasq': 0.01, 'nu': 1.0},
            device=device)
        self.spec = mx.make_spec([(nich, 2)], capacity=CAPACITY,
                                 empties=EMPTY_GROUP_COUNT)
        self.shareds = (self.feature,)

    @property
    def device(self):
        return self.feature.mu.device


def sample_from_image(generator, image, sample_count):
    """Draw (x, y) points with density inverse to pixel intensity, scaled to
    [-1, 1] (reference main.py:126-140), on the CPU from `generator`."""
    image = -1.0 * np.asarray(image, np.float64)
    image -= image.min()
    x_pmf = image.sum(axis=1)
    x_pmf /= x_pmf.sum()
    y_pmfs = image / (image.sum(axis=1, keepdims=True) + 1e-8)

    xs = sample_discrete(generator, torch.from_numpy(x_pmf),
                         shape=(sample_count,), device='cpu').numpy()
    logits = torch.log(torch.from_numpy(y_pmfs[xs]).to(torch.float32)
                       + 1e-12)
    ys = sample_from_scores(generator, logits).numpy()

    x_scale = 2.0 / (image.shape[0] - 1)
    y_scale = 2.0 / (image.shape[1] - 1)
    return np.stack([xs * x_scale - 1.0, ys * y_scale - 1.0],
                    axis=1).astype(np.float32)


def synthesize_image(model, state, width, height):
    """Evaluate the mixture predictive density on the pixel grid
    (reference main.py:143-159)."""
    dev = state.counts.device
    xs = torch.arange(width, device=dev) * (2.0 / (width - 1)) - 1.0
    ys = torch.arange(height, device=dev) * (2.0 / (height - 1)) - 1.0
    grid = torch.stack(torch.meshgrid(xs, ys, indexing='ij'),
                       dim=-1).reshape(-1, 2).to(torch.float32)
    scores = mx.score_batch(model.spec, model.clustering, model.shareds,
                            state, (grid,))
    probs = torch.exp(scores).sum(-1).reshape(width, height)
    image = (probs / probs.max()).cpu().numpy()
    return ((1.0 - image) * 255).astype(np.uint8)


def save_image(image, name, out=RESULTS):
    os.makedirs(out, exist_ok=True)
    path = os.path.join(out, name)
    try:
        from PIL import Image
        Image.fromarray(image).save(path)
    except ImportError:
        path += '.npy'
        np.save(path, image)
    return path


def load_dataset():
    """The tracked points [10000, 2] float32."""
    return np.asarray(list(json_stream_load(SAMPLES)), np.float32)


def create_dataset(generator, sample_count=SAMPLE_COUNT):
    """(image, points): the first `sample_count` tracked points, or as many
    new ones drawn from the image when more are asked for."""
    image = load_image()
    samples = load_dataset()
    if sample_count > len(samples):
        samples = sample_from_image(generator, image, sample_count)
    return image, samples[:sample_count]


def _pad(X, multiple):
    R = X.shape[0]
    pad = (-R) % multiple
    if pad:
        X = np.concatenate([X, X[:pad]], axis=0)
    return X


def _values(model, X):
    return (torch.from_numpy(np.ascontiguousarray(X)).to(model.device),)


def compress_sequential(model, X, generator, passes=PASSES):
    """reference main.py:191-210."""
    state = mx.init(model.spec, model.shareds)
    return gibbs_ops.sequential_init(
        model.spec, model.clustering, model.shareds, state,
        _values(model, X), generator)


def compress_gibbs(model, X, generator, passes=PASSES, init='prior'):
    """reference main.py:213-286 (prior- or sequential-init + Gibbs)."""
    values = _values(model, _pad(X, BLOCK))
    state = mx.init(model.spec, model.shareds)
    first = (gibbs_ops.prior_init if init == 'prior'
             else gibbs_ops.sequential_init)
    state, assignments = first(model.spec, model.clustering, model.shareds,
                               state, values, generator)
    for _ in range(passes):
        state, assignments = gibbs_ops.sweep_blocked(
            model.spec, model.clustering, model.shareds, state, values,
            assignments, BLOCK, generator)
    return state, assignments


def compress_annealing(model, X, generator, passes=PASSES):
    """reference main.py:310-344."""
    return annealing_mod.anneal(
        model.spec, model.clustering, model.shareds,
        _values(model, _pad(X, BLOCK)), generator, passes=passes,
        tile=BLOCK)


def compress_smc(model, X, generator, passes=PASSES, n_particles=8):
    """SMC particle-filter init (no reference analog)."""
    states, assignments, logw, _ = smc_mod.smc_init(
        model.spec, model.clustering, model.shareds, _values(model, X),
        n_particles, 64, generator)
    return smc_mod.best_particle(states, assignments, logw)


STRATEGIES = {
    'sequential': compress_sequential,
    'gibbs': compress_gibbs,
    'seq-gibbs': lambda m, X, g, **kw: compress_gibbs(
        m, X, g, init='sequential', **kw),
    'annealing': compress_annealing,
    'smc': compress_smc,
}


def run_strategy(name, model, X, generator, image_shape, passes=PASSES,
                 out=RESULTS):
    """Fit one strategy, print its components and seconds, save its
    image.  Returns (state, assignments, seconds, image)."""
    t0 = time.time()
    state, assignments = STRATEGIES[name](model, X, generator, passes=passes)
    n_components = int((state.counts > 0).sum())
    dt = time.time() - t0
    print('{} found {} components in {:.1f}s'.format(name, n_components, dt))
    img = synthesize_image(model, state, *image_shape)
    save_image(img, name.replace('-', '_') + '.png', out)
    return state, assignments, dt, img


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument('command', nargs='?', default='run',
                        choices=['run'] + list(STRATEGIES))
    parser.add_argument('--samples', type=int, default=SAMPLE_COUNT)
    parser.add_argument('--passes', type=int, default=PASSES)
    parser.add_argument('--seed', type=int, default=0)
    parser.add_argument('--out', default=RESULTS)
    parser.add_argument('--cpu', action='store_true')
    args = parser.parse_args(argv)
    if args.cpu:
        config.set_default_device('cpu')

    generator = torch.Generator().manual_seed(args.seed)
    image, X = create_dataset(generator, args.samples)
    save_image(image, 'original.png', args.out)
    model = ImageModel()

    names = list(STRATEGIES) if args.command == 'run' else [args.command]
    for name in names:
        run_strategy(name, model, X, generator, image.shape, args.passes,
                     args.out)


if __name__ == '__main__':
    main()
