"""Model definitions over explicit parameter trees (`repro.models`): the
param-meta system (`module`), transformer blocks (`layers`), the decoder
(`transformer`) and the family API (`api`)."""
from . import api, layers, module, transformer
