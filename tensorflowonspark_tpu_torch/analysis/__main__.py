"""``python -m tensorflowonspark_tpu_torch.analysis``: the port's
concurrency lint over its own package, against ``analysis/baseline.json``."""

import sys

from tensorflowonspark_tpu_torch.analysis.racecheck import main

sys.exit(main())
