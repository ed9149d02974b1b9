"""Structured-data (table) service: catalog + UDB SPI + transforms (the
port of ``alluxio_tpu/table``).

Re-design of the reference's ``table/`` module (``table/server/master/
.../AlluxioCatalog.java:55``, ``DefaultTableMaster``, UDB SPI
``table/server/common/.../udb/UnderDatabase.java``,
``transform/TransformManager.java:82``): the catalog snapshots an
under-database's schemas/partitions into journaled master state; reads
are **column projections** straight out of Parquet through the caching FS
client (the path bench config #4 measures); the compact transform runs as
a job-service plan. The port has the ``fs`` under-database only; the JAX
package's Hive and Glue connectors are not ported yet.
"""

from alluxio_tpu_torch.table.master import TableMaster  # noqa: F401
from alluxio_tpu_torch.table.plan import (  # noqa: F401
    ColumnRange, FooterCache, ParquetPlanError, RowGroupPlan, cached_plan,
    coalesce, footer_cache, plan_row_groups, read_footer,
)
from alluxio_tpu_torch.table.udb import (  # noqa: F401
    FsUnderDatabase, UdbPartition, UdbTable, UnderDatabase, udb_factory,
)
