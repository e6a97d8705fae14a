// The cyclic (rolling) hash tile that K11 (cyclic.cu) and K5's cyclic
// variant (rows.cu) hash from: khmer_tpu/ops/rollinghash.py's closed form
// of the reference's CyclicHash<uint64> (src/oxli/kmer_hash.cc:237-278),
//
//     h = XOR_j rotl64(T[s[j]], (k - 1 - j) mod 64)
//     r = XOR_j rotl64(C[s[j]], j mod 64),  C[c] = T[comp(c)]
//     hash = h + r (mod 2^64)
//
// with comp swapping A/T and C/G in either case and keeping every other
// byte, so lowercase, N and IUPAC bytes each have their own entries.
//
// Layout: a block first copies T and C (2 KB each) into shared memory, so
// the 32 lanes of a warp, which look up different bytes, read them without
// serialising (as __constant__ memory would).  Then it stages, for every
// byte position p of its tile (flat byte base + p, for p in
// [0, lanes + k - 1); bytes outside the input read as 0), the two 8-byte
// entries T[b] and C[b], so that a window's O(k) loop reads position
// x + j of two u64 arrays: neighbouring lanes read neighbouring words, and
// the rotation by (k - 1 - j) or j is the same for every lane.
#pragma once

#include "common.cuh"

namespace cyclic {

constexpr int kMaxK = 255;

// rollinghash/characterhash.h's table: ops/rollinghash.py _CYCLIC_TABLE
// (tests/test_torch_cyclic.py holds the two equal)
__device__ const u64 kTable[256] = {
    0x272668aaf7e1e415ULL, 0x9d2b0fc76e794261ULL, 0x4b2a4be7c6cc953cULL,
    0x687ba75236f25e4eULL, 0xbf87c8c480008c53ULL, 0x84d421c289550791ULL,
    0xb8672f8c06a319edULL, 0xec4b56182d3d0216ULL, 0xb262acd48a49fda5ULL,
    0x5876aaed9e888ad5ULL, 0x1e96ed7d463037e5ULL, 0xe2205917952ad63eULL,
    0x00bc1c0f2ba463abULL, 0x59072ef003551ab1ULL, 0xe0cc4dea8379db04ULL,
    0xa34940603682caffULL, 0x47cb2d6fe3b7962bULL, 0x040cdc603888d56fULL,
    0x7dd7bd176801a43dULL, 0x6ad47cd7da9e1feaULL, 0xadc82a5315042c38ULL,
    0x83cfc5c60bb19dddULL, 0xef7f7d197c347d1fULL, 0xc975a6dcf663c031ULL,
    0x78f41fd3e5284569ULL, 0x49e96971da2f9bfbULL, 0xe05b0a01208d8e50ULL,
    0x23a79d4c427ea1cdULL, 0xed7133c46113f196ULL, 0xc0b6bcc1d38cda87ULL,
    0xceb13214630b3727ULL, 0x3ac5929c963853aaULL, 0xc7448456f839d458ULL,
    0x1a3296d8ccddbb34ULL, 0x20562c0a5cadd400ULL, 0x7f841373578784dbULL,
    0x539f0014c72b8aeaULL, 0xf1d0f64cfbaff1a8ULL, 0x69ff92b79a10afcaULL,
    0xaba3c232c90bb967ULL, 0x88901497b3b906e5ULL, 0x922d9dfc5b12ab64ULL,
    0xb749d7e94c09652eULL, 0x65865081278881b1ULL, 0xa5d2e7875d02ecf5ULL,
    0x3292b203cb07ededULL, 0x8648c9d4aedacaa7ULL, 0xccfd988d8157cec4ULL,
    0x1fd038c77d408c2dULL, 0x8d85bda8029fbf28ULL, 0xc34ebac2e113625fULL,
    0x77a70c0a5e5d1058ULL, 0x5b7607f1bfafe833ULL, 0xc03538d2cc22bafaULL,
    0xffc11e857c18844bULL, 0x02fcc098a17ee781ULL, 0x1a2588db76b7d5e7ULL,
    0xafbe864ccb2bd2f8ULL, 0xc8874c1afda879faULL, 0x2faebfcc3463da5fULL,
    0x96dcba4afe6d15daULL, 0x9fa8fb51068a81baULL, 0xa91f6c40827049beULL,
    0xe0cdf279598e3727ULL, 0x94115760a852bb49ULL, 0xe743e147a4d2d320ULL,
    0xff508ce758a30c3fULL, 0xdd71f7807e89c634ULL, 0xcadaf602eec0bed0ULL,
    0xc03dc379a986125cULL, 0x8f064be97e864e3aULL, 0x8282ed28efadf3a7ULL,
    0x78200416cf261c8aULL, 0xb1c43571c3d468daULL, 0x3b23d3a080c5692bULL,
    0x6b5054fe9f02a07cULL, 0xe504f13c98c44ceeULL, 0xd8a7d514a1fb1994ULL,
    0x959a868f389355c6ULL, 0x15685139d06b6013ULL, 0x32b6c7601463a545ULL,
    0xe9132520d2a89144ULL, 0xaba7b9c82af677ffULL, 0x2b7a01af3865fccfULL,
    0x0b9bc70652a7e27bULL, 0xc0fe07bb9fa1d630ULL, 0x88cf598eb841d033ULL,
    0x3cadccc66ab05a6eULL, 0xc5d23b85883a9e3aULL, 0x696aee31a77dfd0fULL,
    0xe2cd19e5de7151fdULL, 0x1b7c4af8470641a4ULL, 0x72a926686d73a6feULL,
    0xb6267c89975ca45fULL, 0xeebe938e6b73c87aULL, 0xe895c261cc701c08ULL,
    0xd4e9ce38cea563abULL, 0x259000f311305f92ULL, 0x9dfd3591e1b3f5e2ULL,
    0xd442f8d190d5fbccULL, 0x5c7b9a39ba7ee0bbULL, 0xc5873fe797add777ULL,
    0xb3235d2ef877f396ULL, 0x12c7fe99423c564cULL, 0xd460e2d838ca3084ULL,
    0x04ae8a6d298c66b9ULL, 0x15c5750839dbec32ULL, 0xf4df855ce367dfd4ULL,
    0x3564bb8fe578c224ULL, 0xf32f2541b4dfefc8ULL, 0xa9d74d52f910accfULL,
    0x362d42885dc89d81ULL, 0x72aed44b8dbaf29eULL, 0xabf185c677fafdedULL,
    0x11f0dc608df64c87ULL, 0x3456fb8b2273d4c3ULL, 0x3f07b04d2fc6cbe8ULL,
    0xcd81840749b1c55fULL, 0x23d4d1d5c30dd82bULL, 0x024e59167a1268d3ULL,
    0x5af59eb6f5355fbbULL, 0xedef993deb201b01ULL, 0xb0b13f7ce0d849a8ULL,
    0xca0e35d75773fe1aULL, 0x0c9f33fbd67c1013ULL, 0x5032b165d1774e74ULL,
    0xe9f96a44422cee26ULL, 0x473fe75717c80cb8ULL, 0xab7479fc1eb5142fULL,
    0xf7b915ce00081966ULL, 0x50c5a1f1630b6591ULL, 0x5b45a9a0ea1b1232ULL,
    0x92f95f193f4701e5ULL, 0x97d324475e129a88ULL, 0x76dd1e74eaef9d39ULL,
    0x189ebec35a8a7822ULL, 0x42cf84bef0f20b57ULL, 0x3b5485cd3677ec24ULL,
    0x08bf737326085769ULL, 0x595166ca6334bc3fULL, 0xe743447e77c48689ULL,
    0x21498d64f4287346ULL, 0x9f2773611cdee6eeULL, 0xf311ba670ab34128ULL,
    0x2c1a6f355241ef48ULL, 0x6ac1f4256f9d5ca8ULL, 0xc0097529b364816eULL,
    0x4c6a3019379f0060ULL, 0x49aba517891d5af6ULL, 0xe558cc8c6a3744c9ULL,
    0x04f53ba58b5139c6ULL, 0x1066b762a5a2b96cULL, 0xe745590781062c3bULL,
    0x231b5419e9f65d5cULL, 0xff4780eb2f618a0fULL, 0x893081cd86293f37ULL,
    0x94215a76933027b1ULL, 0x073f18153eed7af2ULL, 0x750b5fd78bd43e21ULL,
    0x2461fc2b9cef8396ULL, 0x86ed47b0224ad2bfULL, 0x17c1cb3d1dbed879ULL,
    0xf6ffc1e98d0ce352ULL, 0xeab76ca6f2b60dd2ULL, 0x6d97625e59d2bdb1ULL,
    0xdc2acab11c4f2d53ULL, 0xc3633ddcc47a1c4bULL, 0x2a54a707bc9b7494ULL,
    0x17a380905490d2a2ULL, 0x6574c9a465b27009ULL, 0x9f9487548b18ac56ULL,
    0xeebc1448ee797648ULL, 0x8659409bcc56dc56ULL, 0x6a07a7032b525bdbULL,
    0x5a9bc09880d22b24ULL, 0x06b5c365b313c895ULL, 0xb583cf8d6bcfb95cULL,
    0x8d23a195cc582f3bULL, 0x00077eff8cb6ae16ULL, 0xe899b7096fceab28ULL,
    0x92dca8b0a956d710ULL, 0x3c7053c0520ead07ULL, 0x503c913f6d996cd3ULL,
    0x6bcdb58333a571b2ULL, 0x0cc9bff84b039210ULL, 0x2c1e81f94386fd50ULL,
    0x8a71184de26cbb11ULL, 0x07a10fdbb6125546ULL, 0xaf6a8b928775db25ULL,
    0x7235dee2fe46b320ULL, 0x821c82b8bb9a412aULL, 0xb0de9ed99792dac5ULL,
    0x20ccc389f29e792bULL, 0x1d5ffdec5031b5e7ULL, 0x718620fc7fa1b466ULL,
    0x3af90e860a3e2d22ULL, 0x2591cb4f6b9d3968ULL, 0x4c86af0a83e02851ULL,
    0x192d421e77c0ebaeULL, 0x4d65aacb6f7149d2ULL, 0xb13c0e1618b6401fULL,
    0xa6fd0f2d016b5bf3ULL, 0x23318ac852d39a8fULL, 0x9628789570fca2caULL,
    0x4519fe947f403a6eULL, 0xe463042b92da3c1aULL, 0xa9ee72345b4bba95ULL,
    0x699c25501e968e49ULL, 0xc3bc56b51b48566bULL, 0x09ff7e8d1b60cadaULL,
    0xb9db010d44f6aa1bULL, 0x38dd278750b755f2ULL, 0x732d710abd07c42eULL,
    0xe21482cb847657a5ULL, 0x65ce2624d4ff0f3fULL, 0xe19f9e3c696836f9ULL,
    0xf7dffd8910b69dc6ULL, 0xbe25d5f1eddc1ccfULL, 0xf11c39e9cdaf09ebULL,
    0x6e4242f16845537cULL, 0x887d85397baa76e9ULL, 0x0516dd458c43af25ULL,
    0xd5aa0734947b2775ULL, 0x9fc06dd2da2f16fcULL, 0x3124088dfa462e91ULL,
    0x45e69a73c47a4d3fULL, 0x44dd40b7373f168bULL, 0xc3f6d4fd6d0fcff5ULL,
    0xfd26000ff6ecd1daULL, 0xf5383f95a3f1b1faULL, 0x89d63367ed322aefULL,
    0x84a5a5392e85a9c2ULL, 0x0f2a8fea93ca7631ULL, 0x1a6d051a91305b88ULL,
    0x634e1e47b2e8aa4bULL, 0x90df9c57bf233c7dULL, 0x12e4088261b6a0e0ULL,
    0x7e39274d7b243de3ULL, 0x43fadda2d9d156a8ULL, 0x23f065f7d8b840ffULL,
    0xb11edbc481573188ULL, 0x89f0d52f4628bf5aULL, 0x0702df9d2f37736bULL,
    0x8a64cb80f5d71ee0ULL, 0x65928d864cb62b3fULL, 0x787bea729956c061ULL,
    0x60a95e1e64d8cfebULL, 0x613ac9d63ab909deULL, 0x4a252b18a9be6af7ULL,
    0x0da92aef06f6bbf9ULL, 0x4d25f636c9429595ULL, 0x89efe4b2444ecadaULL,
    0x10e5632b9bc2dd9fULL, 0xf06aadde2d4edd43ULL, 0xd78f562da11db813ULL,
    0xc16606cdd3851bd0ULL,
};

// the reverse strand's byte (rollinghash.py _comp_bytes)
__device__ __forceinline__ unsigned complement(unsigned c) {
    switch (c) {
    case 'A': return 'T';
    case 'T': return 'A';
    case 'C': return 'G';
    case 'G': return 'C';
    case 'a': return 't';
    case 't': return 'a';
    case 'c': return 'g';
    case 'g': return 'c';
    default: return c;
    }
}

// x rotated left by r in [0, 63]: a shift of 0 is x | x, never x >> 64
__device__ __forceinline__ u64 rotl(u64 x, int r) {
    return x << r | x >> ((64 - r) & 63);
}

// Stage T[b] and C[b] of the bytes b at flat positions [base, base +
// npos) of src (n bytes) into fwd and rev; tab is a 2 x 256 shared
// table the caller gives.  Ends with a block barrier.
__device__ __forceinline__ void stage(const uint8_t* __restrict__ src,
                                      long long n, long long base, int npos,
                                      u64 (*tab)[256], u64* fwd, u64* rev) {
    for (int c = threadIdx.x; c < 256; c += blockDim.x) {
        tab[0][c] = kTable[c];
        tab[1][c] = kTable[complement(c)];
    }
    __syncthreads();
    for (int p = threadIdx.x; p < npos; p += blockDim.x) {
        const long long g = base + p;
        const unsigned b = g < n ? __ldg(src + g) : 0u;
        fwd[p] = tab[0][b];
        rev[p] = tab[1][b];
    }
    __syncthreads();
}

// canonical hash of the window at tile position x
__device__ __forceinline__ u64 window(const u64* fwd, const u64* rev, int x,
                                      int k) {
    u64 h = 0, r = 0;
    for (int j = 0; j < k; j++) {
        h ^= rotl(fwd[x + j], (k - 1 - j) & 63);
        r ^= rotl(rev[x + j], j & 63);
    }
    return h + r;
}

}  // namespace cyclic
