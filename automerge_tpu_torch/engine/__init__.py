from .columnar import TextChangeBatch  # noqa: F401
from .text_doc import DeviceTextDoc  # noqa: F401
from .wire_columns import (ColumnarChangeBatch, change_columns,  # noqa: F401
                           decode_text_changes_columnar)
