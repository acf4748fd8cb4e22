// Native RV64IM interpreter with columnar trace recording.
//
// Exact twin of zigz_tpu/vm/state.py (itself a bit-exact twin of the
// reference state.zig) — the VM feeds the witness and therefore the
// Fiat-Shamir transcript, so every semantic edge must match:
//   * opcode-0 decode failure sets halted and stops with STATUS_INVALID
//     (no step recorded); other unimplemented/invalid encodings stop with
//     distinct statuses and DO NOT set halted (state.zig:136-140, 206-214);
//   * RV64M division edge cases (div-by-zero => -1 / dividend;
//     INT_MIN/-1 => dividend / 0) per state.zig:247-282;
//   * ECALL a7=1 commits a0, a7=2 pops the input tape (0 on underflow),
//     unknown syscalls no-op; EBREAK halts with next_pc == pc
//     (state.zig:564-597);
//   * sparse byte memory, little-endian composition, zero default
//     (memory.zig).
//
// The trace is recorded columnar (one array per field) so Python can wrap
// it zero-copy for the vectorized witness generator.  Memory is a paged
// (4 KiB) hash map — semantically identical to the reference's byte map
// (unmapped reads 0) but ~10x faster.
//
// Build: g++ -O3 -march=native -shared -fPIC vm.cpp -o libzigz_vm.so

#include <cstdint>
#include <cstring>
#include <unordered_map>
#include <vector>

namespace {

constexpr uint64_t ECALL_COMMIT = 1;
constexpr uint64_t ECALL_READ = 2;

// Status codes returned to Python.
enum Status : int32_t {
  STATUS_OK = 0,           // ran to max_steps without halting
  STATUS_HALTED = 1,       // EBREAK
  STATUS_INVALID = 2,      // decode failure (opcode 0) -> clean halt
  STATUS_UNIMPLEMENTED = 3,  // FP/AMO/unknown opcode
  STATUS_UNIMPL_SYSTEM = 4,  // CSR / unknown SYSTEM encoding
  STATUS_INVALID_VARIANT = 5,  // bad funct3 for OP_32/OP_IMM_32/LOAD/STORE/BRANCH
};

// Lookup-table catalog ids (presence drives per-step Lasso bindings;
// ids match zigz_tpu.isa.instruction_table.get_table_metadata).
enum LookupId : int8_t {
  LK_NONE = -1, LK_ADD = 0, LK_SUB, LK_AND, LK_OR, LK_XOR, LK_SLL,
  LK_SRL, LK_SRA, LK_SLT, LK_SLTU, LK_BEQ, LK_LOAD, LK_STORE,
};

struct PagedMemory {
  static constexpr uint64_t PAGE_BITS = 12;
  static constexpr uint64_t PAGE_SIZE = 1ull << PAGE_BITS;
  std::unordered_map<uint64_t, std::vector<uint8_t>> pages;

  uint8_t* page(uint64_t addr, bool create) {
    uint64_t key = addr >> PAGE_BITS;
    auto it = pages.find(key);
    if (it == pages.end()) {
      if (!create) return nullptr;
      it = pages.emplace(key, std::vector<uint8_t>(PAGE_SIZE, 0)).first;
    }
    return it->second.data();
  }

  uint8_t load_byte(uint64_t addr) {
    uint8_t* p = page(addr, false);
    return p ? p[addr & (PAGE_SIZE - 1)] : 0;
  }

  void store_byte(uint64_t addr, uint8_t value) {
    // (The reference deletes zero bytes to stay sparse; observable
    // semantics — loads — are identical either way.)
    page(addr, true)[addr & (PAGE_SIZE - 1)] = value;
  }

  uint32_t load_u32(uint64_t addr) {
    // Fast path: within one page.
    uint64_t off = addr & (PAGE_SIZE - 1);
    uint8_t* p = page(addr, false);
    if (p && off + 4 <= PAGE_SIZE) {
      uint32_t v;
      std::memcpy(&v, p + off, 4);
      return v;
    }
    return (uint32_t)load_byte(addr) | ((uint32_t)load_byte(addr + 1) << 8) |
           ((uint32_t)load_byte(addr + 2) << 16) |
           ((uint32_t)load_byte(addr + 3) << 24);
  }

  uint64_t load_u64(uint64_t addr) {
    return (uint64_t)load_u32(addr) | ((uint64_t)load_u32(addr + 4) << 32);
  }

  uint16_t load_u16(uint64_t addr) {
    return (uint16_t)((uint16_t)load_byte(addr) |
                      ((uint16_t)load_byte(addr + 1) << 8));
  }

  void store_u16(uint64_t addr, uint16_t v) {
    store_byte(addr, (uint8_t)v);
    store_byte(addr + 1, (uint8_t)(v >> 8));
  }

  void store_u32(uint64_t addr, uint32_t v) {
    uint64_t off = addr & (PAGE_SIZE - 1);
    uint8_t* p = page(addr, true);
    if (off + 4 <= PAGE_SIZE) {
      std::memcpy(p + off, &v, 4);
      return;
    }
    for (int i = 0; i < 4; ++i) store_byte(addr + i, (uint8_t)(v >> (8 * i)));
  }

  void store_u64(uint64_t addr, uint64_t v) {
    store_u32(addr, (uint32_t)v);
    store_u32(addr + 4, (uint32_t)(v >> 32));
  }
};

struct TraceColumns {
  uint64_t* pc;
  uint64_t* next_pc;
  uint32_t* inst_word;
  uint8_t* opcode;
  uint8_t* rd;
  uint8_t* rs1;
  uint8_t* rs2;
  uint8_t* funct3;
  uint8_t* funct7;
  int64_t* imm;
  uint8_t* reg_write_idx;   // 0 = no write (x0 writes are ignored anyway)
  uint64_t* reg_write_val;
  uint8_t* mem_flag;        // 0 none, 1 load, 2 store
  uint64_t* mem_addr;
  uint64_t* mem_val;
  uint8_t* mem_size;        // 0 byte, 1 half, 2 word, 3 dword
  int8_t* lookup_id;        // LookupId or -1
};

inline int8_t lookup_for(uint8_t opcode, uint8_t funct3, uint8_t funct7) {
  switch (opcode) {
    case 0x33: {  // OP
      switch (funct3) {
        case 0: return funct7 == 0 ? LK_ADD : LK_SUB;
        case 1: return LK_SLL;
        case 2: return LK_SLT;
        case 3: return LK_SLTU;
        case 4: return LK_XOR;
        case 5: return funct7 == 0 ? LK_SRL : LK_SRA;
        case 6: return LK_OR;
        case 7: return LK_AND;
      }
      return LK_NONE;
    }
    case 0x13: {  // OP_IMM
      switch (funct3) {
        case 0: return LK_ADD;
        case 1: return LK_SLL;
        case 2: return LK_SLT;
        case 3: return LK_SLTU;
        case 4: return LK_XOR;
        case 5: return funct7 == 0 ? LK_SRL : LK_SRA;
        case 6: return LK_OR;
        case 7: return LK_AND;
      }
      return LK_NONE;
    }
    case 0x03: return LK_LOAD;
    case 0x23: return LK_STORE;
    case 0x63: return LK_BEQ;  // all branch variants share the BEQ table
    default: return LK_NONE;
  }
}

inline int64_t sext(uint64_t value, int bits) {
  uint64_t m = 1ull << (bits - 1);
  return (int64_t)((value ^ m) - m);
}

// Immediate decoding per format (rv64i.zig:156-233).
inline int64_t decode_imm(uint32_t inst, uint8_t opcode) {
  switch (opcode) {
    // I-type
    case 0x13: case 0x1B: case 0x67: case 0x03: case 0x07: case 0x0F:
    case 0x73:
      return sext((inst >> 20) & 0xFFF, 12);
    // S-type
    case 0x23: case 0x27:
      return sext((((inst >> 25) & 0x7F) << 5) | ((inst >> 7) & 0x1F), 12);
    // B-type
    case 0x63:
      return sext((((inst >> 31) & 1) << 12) | (((inst >> 7) & 1) << 11) |
                      (((inst >> 25) & 0x3F) << 5) | (((inst >> 8) & 0xF) << 1),
                  13);
    // U-type
    case 0x37: case 0x17:
      return (int64_t)(int32_t)(inst & 0xFFFFF000u);
    // J-type
    case 0x6F:
      return sext((((inst >> 31) & 1) << 20) | (((inst >> 12) & 0xFF) << 12) |
                      (((inst >> 20) & 1) << 11) | (((inst >> 21) & 0x3FF) << 1),
                  21);
    default:
      return 0;  // R-type / unknown (default R format)
  }
}

struct VM {
  PagedMemory mem;
  uint64_t regs[32] = {0};
  uint64_t pc = 0;
  bool halted = false;
  const uint64_t* input_tape = nullptr;
  size_t input_len = 0, input_pos = 0;
  uint64_t* output_tape = nullptr;
  size_t output_cap = 0, output_len = 0;
};

}  // namespace

extern "C" {

VM* zigz_vm_create() { return new VM(); }
void zigz_vm_destroy(VM* vm) { delete vm; }

void zigz_vm_load_segment(VM* vm, uint64_t vaddr, const uint8_t* data,
                          size_t len) {
  for (size_t i = 0; i < len; ++i) vm->mem.store_byte(vaddr + i, data[i]);
}

void zigz_vm_set_pc(VM* vm, uint64_t pc) { vm->pc = pc; }
void zigz_vm_set_reg(VM* vm, int idx, uint64_t val) {
  if (idx > 0 && idx < 32) vm->regs[idx] = val;
}
uint64_t zigz_vm_get_reg(VM* vm, int idx) {
  return (idx > 0 && idx < 32) ? vm->regs[idx] : 0;
}
uint64_t zigz_vm_get_pc(VM* vm) { return vm->pc; }
int zigz_vm_is_halted(VM* vm) { return vm->halted ? 1 : 0; }
size_t zigz_vm_output_len(VM* vm) { return vm->output_len; }
size_t zigz_vm_input_pos(VM* vm) { return vm->input_pos; }

void zigz_vm_set_input(VM* vm, const uint64_t* tape, size_t len) {
  vm->input_tape = tape;
  vm->input_len = len;
  vm->input_pos = 0;
}

void zigz_vm_set_output_buffer(VM* vm, uint64_t* buf, size_t cap) {
  vm->output_tape = buf;
  vm->output_cap = cap;
  vm->output_len = 0;
}

uint8_t zigz_vm_load_byte(VM* vm, uint64_t addr) {
  return vm->mem.load_byte(addr);
}

// Run up to max_steps, recording the trace into the provided columns.
// Returns the number of steps recorded; *status_out receives a Status.
uint64_t zigz_vm_run(VM* vm, uint64_t max_steps, TraceColumns* cols,
                     int32_t* status_out) {
  uint64_t steps = 0;
  int32_t status = STATUS_OK;

  while (!vm->halted && steps < max_steps) {
    uint64_t pc = vm->pc;
    uint32_t inst = vm->mem.load_u32(pc);
    uint8_t opcode = inst & 0x7F;
    if (opcode == 0) {
      vm->halted = true;
      status = STATUS_INVALID;
      break;
    }
    uint8_t rd = (inst >> 7) & 0x1F;
    uint8_t funct3 = (inst >> 12) & 0x07;
    uint8_t rs1 = (inst >> 15) & 0x1F;
    uint8_t rs2 = (inst >> 20) & 0x1F;
    uint8_t funct7 = (inst >> 25) & 0x7F;
    int64_t imm = decode_imm(inst, opcode);

    uint64_t next_pc = pc + 4;
    uint8_t wr_idx = 0;
    uint64_t wr_val = 0;
    uint8_t mem_flag = 0, mem_size = 0;
    uint64_t mem_addr = 0, mem_val = 0;
    bool stop = false;

    auto write_reg = [&](uint8_t r, uint64_t v) {
      if (r != 0) {
        vm->regs[r] = v;
        wr_idx = r;
        wr_val = v;
      }
    };

    switch (opcode) {
      case 0x33: {  // OP
        uint64_t a = vm->regs[rs1], b = vm->regs[rs2];
        if (rs1 == 0) a = 0;
        if (rs2 == 0) b = 0;
        uint64_t result = 0;
        if (funct7 == 1) {  // RV64M
          switch (funct3) {
            case 0: result = a * b; break;  // MUL
            case 1: {  // MULH
              __int128 p = (__int128)(int64_t)a * (int64_t)b;
              result = (uint64_t)(p >> 64);
              break;
            }
            case 2: {  // MULHSU
              __int128 p = (__int128)(int64_t)a * (__int128)b;
              result = (uint64_t)(p >> 64);
              break;
            }
            case 3: {  // MULHU
              unsigned __int128 p = (unsigned __int128)a * b;
              result = (uint64_t)(p >> 64);
              break;
            }
            case 4: {  // DIV
              int64_t sa = (int64_t)a, sb = (int64_t)b;
              if (sb == 0) result = ~0ull;
              else if (sa == INT64_MIN && sb == -1) result = a;
              else result = (uint64_t)(sa / sb);
              break;
            }
            case 5: result = b == 0 ? ~0ull : a / b; break;  // DIVU
            case 6: {  // REM
              int64_t sa = (int64_t)a, sb = (int64_t)b;
              if (sb == 0) result = a;
              else if (sa == INT64_MIN && sb == -1) result = 0;
              else result = (uint64_t)(sa % sb);
              break;
            }
            case 7: result = b == 0 ? a : a % b; break;  // REMU
          }
        } else {
          switch (funct3) {
            case 0: result = funct7 == 0x20 ? a - b : a + b; break;
            case 1: result = a << (b & 0x3F); break;
            case 2: result = (int64_t)a < (int64_t)b ? 1 : 0; break;
            case 3: result = a < b ? 1 : 0; break;
            case 4: result = a ^ b; break;
            case 5:
              result = funct7 == 0x20 ? (uint64_t)((int64_t)a >> (b & 0x3F))
                                      : a >> (b & 0x3F);
              break;
            case 6: result = a | b; break;
            case 7: result = a & b; break;
          }
        }
        write_reg(rd, result);
        break;
      }
      case 0x3B: {  // OP_32
        uint32_t a = (uint32_t)vm->regs[rs1], b = (uint32_t)vm->regs[rs2];
        if (rs1 == 0) a = 0;
        if (rs2 == 0) b = 0;
        uint32_t r32 = 0;
        if (funct7 == 1) {
          switch (funct3) {
            case 0: r32 = a * b; break;  // MULW
            case 4: {  // DIVW
              int32_t sa = (int32_t)a, sb = (int32_t)b;
              if (sb == 0) r32 = ~0u;
              else if (sa == INT32_MIN && sb == -1) r32 = a;
              else r32 = (uint32_t)(sa / sb);
              break;
            }
            case 5: r32 = b == 0 ? ~0u : a / b; break;
            case 6: {  // REMW
              int32_t sa = (int32_t)a, sb = (int32_t)b;
              if (sb == 0) r32 = a;
              else if (sa == INT32_MIN && sb == -1) r32 = 0;
              else r32 = (uint32_t)(sa % sb);
              break;
            }
            case 7: r32 = b == 0 ? a : a % b; break;
            default: status = STATUS_INVALID_VARIANT; stop = true; break;
          }
        } else {
          switch (funct3) {
            case 0: r32 = funct7 == 0x20 ? a - b : a + b; break;
            case 1: r32 = a << (b & 0x1F); break;
            case 5:
              r32 = funct7 == 0x20 ? (uint32_t)((int32_t)a >> (b & 0x1F))
                                   : a >> (b & 0x1F);
              break;
            default: status = STATUS_INVALID_VARIANT; stop = true; break;
          }
        }
        if (!stop) write_reg(rd, (uint64_t)(int64_t)(int32_t)r32);
        break;
      }
      case 0x13: {  // OP_IMM
        uint64_t a = rs1 ? vm->regs[rs1] : 0;
        uint64_t uimm = (uint64_t)imm;
        uint64_t result = 0;
        switch (funct3) {
          case 0: result = a + uimm; break;
          case 1: result = a << (uimm & 0x3F); break;
          case 2: result = (int64_t)a < imm ? 1 : 0; break;
          case 3: result = a < uimm ? 1 : 0; break;
          case 4: result = a ^ uimm; break;
          case 5:
            result = funct7 == 0x20 ? (uint64_t)((int64_t)a >> (uimm & 0x3F))
                                    : a >> (uimm & 0x3F);
            break;
          case 6: result = a | uimm; break;
          case 7: result = a & uimm; break;
        }
        write_reg(rd, result);
        break;
      }
      case 0x1B: {  // OP_IMM_32
        uint32_t a = rs1 ? (uint32_t)vm->regs[rs1] : 0;
        uint64_t uimm = (uint64_t)imm;
        uint32_t r32 = 0;
        switch (funct3) {
          case 0: r32 = a + (uint32_t)uimm; break;
          case 1: r32 = a << (uimm & 0x1F); break;
          case 5:
            r32 = funct7 == 0x20 ? (uint32_t)((int32_t)a >> (uimm & 0x1F))
                                 : a >> (uimm & 0x1F);
            break;
          default: status = STATUS_INVALID_VARIANT; stop = true; break;
        }
        if (!stop) write_reg(rd, (uint64_t)(int64_t)(int32_t)r32);
        break;
      }
      case 0x03: {  // LOAD
        uint64_t base = rs1 ? vm->regs[rs1] : 0;
        uint64_t addr = base + (uint64_t)imm;
        uint64_t result = 0;
        switch (funct3) {
          case 0: result = (uint64_t)(int64_t)(int8_t)vm->mem.load_byte(addr); mem_size = 0; break;
          case 1: result = (uint64_t)(int64_t)(int16_t)vm->mem.load_u16(addr); mem_size = 1; break;
          case 2: result = (uint64_t)(int64_t)(int32_t)vm->mem.load_u32(addr); mem_size = 2; break;
          case 3: result = vm->mem.load_u64(addr); mem_size = 3; break;
          case 4: result = vm->mem.load_byte(addr); mem_size = 0; break;
          case 5: result = vm->mem.load_u16(addr); mem_size = 1; break;
          case 6: result = vm->mem.load_u32(addr); mem_size = 2; break;
          default: status = STATUS_INVALID_VARIANT; stop = true; break;
        }
        if (!stop) {
          mem_flag = 1;
          mem_addr = addr;
          mem_val = result;
          write_reg(rd, result);
        }
        break;
      }
      case 0x23: {  // STORE
        uint64_t base = rs1 ? vm->regs[rs1] : 0;
        uint64_t addr = base + (uint64_t)imm;
        uint64_t value = rs2 ? vm->regs[rs2] : 0;
        switch (funct3) {
          case 0: vm->mem.store_byte(addr, (uint8_t)value); mem_size = 0; break;
          case 1: vm->mem.store_u16(addr, (uint16_t)value); mem_size = 1; break;
          case 2: vm->mem.store_u32(addr, (uint32_t)value); mem_size = 2; break;
          case 3: vm->mem.store_u64(addr, value); mem_size = 3; break;
          default: status = STATUS_INVALID_VARIANT; stop = true; break;
        }
        if (!stop) {
          mem_flag = 2;
          mem_addr = addr;
          mem_val = value;
        }
        break;
      }
      case 0x63: {  // BRANCH
        uint64_t a = rs1 ? vm->regs[rs1] : 0;
        uint64_t b = rs2 ? vm->regs[rs2] : 0;
        bool taken = false;
        switch (funct3) {
          case 0: taken = a == b; break;
          case 1: taken = a != b; break;
          case 4: taken = (int64_t)a < (int64_t)b; break;
          case 5: taken = (int64_t)a >= (int64_t)b; break;
          case 6: taken = a < b; break;
          case 7: taken = a >= b; break;
          default: status = STATUS_INVALID_VARIANT; stop = true; break;
        }
        if (!stop && taken) next_pc = pc + (uint64_t)imm;
        break;
      }
      case 0x6F:  // JAL
        write_reg(rd, pc + 4);
        next_pc = pc + (uint64_t)imm;
        break;
      case 0x67: {  // JALR
        uint64_t base = rs1 ? vm->regs[rs1] : 0;
        write_reg(rd, pc + 4);
        next_pc = (base + (uint64_t)imm) & ~1ull;
        break;
      }
      case 0x37:  // LUI
        write_reg(rd, (uint64_t)imm);
        break;
      case 0x17:  // AUIPC
        write_reg(rd, pc + (uint64_t)imm);
        break;
      case 0x73: {  // SYSTEM
        if (funct3 == 0 && imm == 0) {  // ECALL
          uint64_t syscall = vm->regs[17];
          if (syscall == ECALL_COMMIT) {
            if (vm->output_len < vm->output_cap)
              vm->output_tape[vm->output_len++] = vm->regs[10];
          } else if (syscall == ECALL_READ) {
            if (vm->input_pos < vm->input_len) {
              write_reg(10, vm->input_tape[vm->input_pos++]);
            } else {
              write_reg(10, 0);
            }
          }
        } else if (funct3 == 0 && imm == 1) {  // EBREAK
          vm->halted = true;
          next_pc = pc;
          status = STATUS_HALTED;
        } else {
          status = STATUS_UNIMPL_SYSTEM;
          stop = true;
        }
        break;
      }
      case 0x0F:  // MISC_MEM (FENCE) — no-op
        break;
      default:
        status = STATUS_UNIMPLEMENTED;
        stop = true;
        break;
    }

    if (stop) break;  // error statuses: no step recorded, pc unchanged

    cols->pc[steps] = pc;
    cols->next_pc[steps] = next_pc;
    cols->inst_word[steps] = inst;
    cols->opcode[steps] = opcode;
    cols->rd[steps] = rd;
    cols->rs1[steps] = rs1;
    cols->rs2[steps] = rs2;
    cols->funct3[steps] = funct3;
    cols->funct7[steps] = funct7;
    cols->imm[steps] = imm;
    cols->reg_write_idx[steps] = wr_idx;
    cols->reg_write_val[steps] = wr_val;
    cols->mem_flag[steps] = mem_flag;
    cols->mem_addr[steps] = mem_addr;
    cols->mem_val[steps] = mem_val;
    cols->mem_size[steps] = mem_size;
    cols->lookup_id[steps] = lookup_for(opcode, funct3, funct7);

    vm->pc = next_pc;
    ++steps;
  }

  *status_out = status;
  return steps;
}

void zigz_vm_get_regs(VM* vm, uint64_t* out) {
  std::memcpy(out, vm->regs, sizeof(vm->regs));
  out[0] = 0;
}

}  // extern "C"
