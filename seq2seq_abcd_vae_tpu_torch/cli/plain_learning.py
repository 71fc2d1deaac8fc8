"""Training entry point of the plain Gaussian VAE (the port's counterpart of
the reference's plain/learning.py):

    python -m seq2seq_abcd_vae_tpu_torch.cli.plain_learning INPUT_ROOT \\
        ANNOTATION.csv -S SAVE_ROOT -j JOB [-f 16] [-d cuda|cpu] [options]

``learning_main.main`` with the ``plain`` variant.
"""

import sys

from .learning_main import main

if __name__ == "__main__":
    main(sys.argv[1:], variant="plain")
