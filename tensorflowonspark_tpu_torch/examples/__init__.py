"""The port's example drivers — the reference's ``examples/`` run on the
PyTorch/CUDA package, with its layout and names.

Each driver runs as a module from the root of a checkout::

    python -m tensorflowonspark_tpu_torch.examples.mnist.mnist_spark \
        --cluster_size 2 --images data/mnist/train --device cpu

Trainers take the card unless ``--device cpu`` is given; the driver and
the executors never touch CUDA (``map_fun``s import torch inside the
function). ``tests/test_torch_examples.py`` runs every driver at its
smallest size on the CPU.
"""
