from . import stacked  # noqa: F401
from .columnar import MapChangeBatch, TextChangeBatch  # noqa: F401
from .doc_set import DeviceTextDocSet  # noqa: F401
from .map_doc import DeviceMapDoc  # noqa: F401
from .pipeline import PipelinedIngestor  # noqa: F401
from .text_doc import DeviceTextDoc  # noqa: F401
from .wire_columns import (ColumnarChangeBatch, change_columns,  # noqa: F401
                           decode_text_changes_columnar)
