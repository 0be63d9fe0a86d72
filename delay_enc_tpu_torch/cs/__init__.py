from .builder import Builder, Cell
from .maingate import MainGate, Term
from .range import RangeChip
from .mock import mock_prove, MockFailure
