"""Model definitions over explicit parameter trees (`repro.models`): the
param-meta system (`module`), transformer blocks (`layers`), the decoder
(`transformer`), the Mamba2 SSM (`mamba2`), the Zamba2-style hybrid
(`hybrid`) and the family API (`api`)."""
from . import api, hybrid, layers, mamba2, module, transformer
