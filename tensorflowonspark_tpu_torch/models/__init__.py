"""Model zoo of the port (PyTorch ``nn.Module``s) — the counterpart of
``tensorflowonspark_tpu/models``.

The reference's example model families (SURVEY.md §2.1): MNIST LeNet
(:mod:`.lenet`), ResNet (:mod:`.resnet`), Inception-v3
(:mod:`.inception`), U-Net (:mod:`.unet`), plus the BASELINE.json
configurations BERT-base SQuAD (:mod:`.bert`) and Wide & Deep Criteo
(:mod:`.widedeep`), and the decoder LM behind serving (:mod:`.decoder`).
Each keeps the reference's class names, defaults and forward inputs
(images NHWC at the boundary), bfloat16 products with float32
parameters, and flax's layer conventions (:mod:`._layers`);
``convert.py`` maps flax parameter trees onto them by name. The mode is
the module's ``training`` flag.

Importing this package imports no submodule.
"""
