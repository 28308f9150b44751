from .bitwriter import Bitstream
from .cabac import Cabac, CabacDecoder, init_contexts
