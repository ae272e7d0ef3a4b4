"""Rule modules self-register on import (``analysis.lint.register``).

Importing this package loads every rule; ``lint.all_rules()`` does it
lazily so the framework core stays import-cheap.
"""

from netsdb_tpu_torch.analysis.rules import compilation  # noqa: F401
from netsdb_tpu_torch.analysis.rules import discipline  # noqa: F401
from netsdb_tpu_torch.analysis.rules import drift  # noqa: F401
from netsdb_tpu_torch.analysis.rules import locking  # noqa: F401
from netsdb_tpu_torch.analysis.rules import races  # noqa: F401
from netsdb_tpu_torch.analysis.rules import resources  # noqa: F401
