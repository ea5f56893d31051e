from .args import parse_args
from .hocon import ConfigTree, from_dict, parse_file, parse_string

__all__ = ["ConfigTree", "from_dict", "parse_args", "parse_file", "parse_string"]
