"""Multi-process data and tensor parallelism (JAX ``parallel``).

The names of ``multimodal_isic_tpu/parallel/__init__.py`` where they have a
counterpart: ``make_mesh`` is :func:`make_grid`, ``shard_batch`` /
``data_sharding`` are :func:`shard_rows`, ``replicated`` is
:func:`replicate_`, ``global_mesh`` is ``make_grid()`` over every rank;
``host_local_batch_to_global`` has none (a rank keeps its rows: there is
no global array to assemble).
"""

from .distributed import (  # noqa: F401
    initialize,
    is_coordinator,
    process_epoch_order,
    process_local_rows,
)
from .sharding import (  # noqa: F401
    Grid,
    make_grid,
    pad_to_multiple,
    replicate_,
    shard_rows,
)
