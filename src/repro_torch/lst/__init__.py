from repro_torch.lst.files import DataFile, ManifestFile, Snapshot, TableMetadata  # noqa
from repro_torch.lst.storage import InMemoryStore, LocalFSStore, ObjectStore  # noqa
from repro_torch.lst.table import CommitConflict, LogStructuredTable, Transaction  # noqa
from repro_torch.lst.catalog import Catalog, Namespace  # noqa
from repro_torch.lst.retention import (DeleteRoute, PredicateDelete,  # noqa
                                       RetentionPolicy, execute_file_drops,
                                       plan_rewrite_delete, route_delete)
from repro_torch.lst.interop import load_catalog, load_table  # noqa
