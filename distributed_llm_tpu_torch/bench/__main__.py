"""``python -m distributed_llm_tpu_torch.bench``: the headline benchmark
(``bench/headline.py``); its last stdout line is the compact result."""

import sys

from .headline import main

sys.exit(main())
