from .parser import QasmError, parse_qasm, parse_qasm_file

__all__ = ["QasmError", "parse_qasm", "parse_qasm_file"]
