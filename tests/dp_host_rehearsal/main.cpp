// Runs one launch of dp.cu's C entry points on the host stand-in.
//   rehearse in.bin out.bin
// in.bin: int32 kernel (0 dp_small, 1 dp_any), B, L, K, wpb, cs; then uint8
// q[B*L], t[B*L]; int32 ql[B], tl[B]. out.bin: uint8 ops[B*2L], then dp_any's
// direction words (uint32). tests/test_torch_dp_rehearsal.py builds it: copy
// this directory and gsalign_tpu_torch/csrc/dp.cu into one directory (dp.cu
// must find the stand-in dp_dev.cuh beside it, not the real one) and there
//   g++ -std=c++20 -O1 -pthread -I. -x c++ main.cpp -o rehearse
#include "dp.cu"
#include <cstdio>
int main(int argc, char** argv) {
  FILE* f = fopen(argv[1], "rb"); int h[6]; fread(h, 4, 6, f);
  int kern = h[0], B = h[1], L = h[2], K = h[3], wpb = h[4], cs = h[5];
  std::vector<uint8_t> q(B * L), t(B * L); std::vector<int32_t> ql(B), tl(B);
  fread(q.data(), 1, B * L, f); fread(t.data(), 1, B * L, f); fread(ql.data(), 4, B, f); fread(tl.data(), 4, B, f); fclose(f);
  std::vector<uint8_t> ops(B * 2 * L, 0xEE);
  int strips = (L + 32 * K - 1) / (32 * K);
  std::vector<uint32_t> dirs((size_t)B * strips * (L / 8) * K * 32, 0xDEADBEEF);
  std::vector<uint16_t> rows(B * 2 * L, 0xCDCD);
  int rc = kern == 0 ? gsalign_dp_small(q.data(), t.data(), ql.data(), tl.data(), B, L, ops.data(), K, wpb, nullptr)
                     : gsalign_dp_any(q.data(), t.data(), ql.data(), tl.data(), B, L, ops.data(), dirs.data(), rows.data(), K, wpb, cs, nullptr);
  if (rc) { fprintf(stderr, "rc %d\n", rc); return 2; }
  f = fopen(argv[2], "wb"); fwrite(ops.data(), 1, ops.size(), f); fwrite(dirs.data(), 4, dirs.size(), f); fclose(f);
  return 0;
}
