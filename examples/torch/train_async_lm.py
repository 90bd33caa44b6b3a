"""End-to-end driver on the PyTorch port: asynchronous LM pre-training with
Generalized AsyncSGD.

Trains a transformer (reduced Granite-family config by default; pass
--preset 100m for a ~100M-parameter model) for a few hundred server steps on
synthetic non-iid LM streams with heterogeneous client speeds, using the
paper's importance-weighted asynchronous updates and Jackson-optimal
sampling.  Prints eval loss vs CS steps and the realized queueing delays.
Runs on the GPU unless ``--device cpu`` is given:

    PYTHONPATH=src python examples/torch/train_async_lm.py --steps 300
    PYTHONPATH=src python examples/torch/train_async_lm.py --preset 100m --steps 200
"""
import sys

from repro_torch.launch.train import main as train_main

if __name__ == "__main__":
    train_main(["--mode", "lm", *sys.argv[1:]])
