// Lazily reduced BLS12-377 Fq and Fq2 for the one-thread group law: the
// values of ec.cuh's lazy coordinate policies, which lane_bucket (bucket.cu)
// and lane_fixed_base (fixed_base_team.cu's one-thread kernel) run.
//
// Replaces the lazy reduction of the TPU kernels: testudo_tpu/tpu/pallas_curve.py
// `RV` (:89-96), `_RowOpsFq` (:149-250), `_RowOpsFq2` (:253-319), `K_CARRY`
// (:154, :257) and `finalize` (:191), on the `lazy=True` product of
// pallas_field.py:86-94.  A value carries its static bound k (value < k p)
// in its type, `LFq<K>`: the compiler tracks it, as the TPU kernel's trace
// did, at no cost at run time, and a bound that would not fit the 12 words
// (k p >= 2^384) fails to compile (LFq's static_assert).
//   - Sums, differences (a - b + k_b p, one ripple, FQ_KP) and small
//     multiples (c <= 15) skip the conditional subtract.
//   - A product skips its final one (fp_mul_lazy: result < 2p, k = 2).
//     `lz_cap` is the one place that holds its operands to ka kb p <= R: it
//     halves the larger bound (k -> ceil(k/2), `_reduce_once`: subtract
//     ceil(k/2) p where the value reaches it) until the cap holds.  Only
//     lz_mul_to and lz2_mul_core reach fp_mul_lazy, each through lz_cap.
//   - `lz_reduce_to`, `lz_clamp` (a loop-carried accumulator's fixed bound,
//     K_CARRY) and `lz_finalize` (canonical, < p) as pallas_curve.py's
//     reduce_to / clamp / finalize.
// Every reduction computes and selects: no branch on a value.  Values are
// canonical again at every kernel edge, so every word a kernel writes
// equals what the strict layer (fp.cuh, fp2.cuh) writes; the intermediates
// differ.
//
// Bound on this card: operations.  The strict layer pays a 12-word subtract
// and select after every sum, difference and product; here a G1 complete
// add pays none but its products, a G2 product three (its c0 and c1 to 4).
//
// Compiles as plain C++ too (csrc/host_check.cpp).
#pragma once
#include "fp2.cuh"

// floor(R / p) for BLS12-377's Fq, R = 2^384 (p has 377 bits): k p < R for
// every bound k up to it, and ka kb p <= R exactly when ka kb is at most it.
#define FQ_R_OVER_P 152
#define FQ_KP_MAX 76  // ceil(FQ_R_OVER_P / 2): every bound can be halved

// m p for m = 0 .. FQ_KP_MAX, 12 little-endian words each: the constants of
// the lazy difference (k_b p) and of the halving subtract (ceil(k/2) p).
// tests/test_torch_lazy_field.py checks every row against m * P.
FP_TABLE u32 FQ_KP[FQ_KP_MAX + 1][FQN] = {
    {0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u,
     0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u},  // 0
    {0x00000001u, 0x8508c000u, 0x30000000u, 0x170b5d44u, 0xba094800u, 0x1ef3622fu,
     0x00f5138fu, 0x1a22d9f3u, 0x6ca1493bu, 0xc63b05c0u, 0x17c510eau, 0x01ae3a46u},  // 1
    {0x00000002u, 0x0a118000u, 0x60000001u, 0x2e16ba88u, 0x74129000u, 0x3de6c45fu,
     0x01ea271eu, 0x3445b3e6u, 0xd9429276u, 0x8c760b80u, 0x2f8a21d5u, 0x035c748cu},  // 2
    {0x00000003u, 0x8f1a4000u, 0x90000001u, 0x452217ccu, 0x2e1bd800u, 0x5cda268fu,
     0x02df3aadu, 0x4e688dd9u, 0x45e3dbb1u, 0x52b11141u, 0x474f32c0u, 0x050aaed2u},  // 3
    {0x00000004u, 0x14230000u, 0xc0000002u, 0x5c2d7510u, 0xe8252000u, 0x7bcd88beu,
     0x03d44e3cu, 0x688b67ccu, 0xb28524ecu, 0x18ec1701u, 0x5f1443abu, 0x06b8e918u},  // 4
    {0x00000005u, 0x992bc000u, 0xf0000002u, 0x7338d254u, 0xa22e6800u, 0x9ac0eaeeu,
     0x04c961cbu, 0x82ae41bfu, 0x1f266e27u, 0xdf271cc2u, 0x76d95495u, 0x0867235eu},  // 5
    {0x00000006u, 0x1e348000u, 0x20000003u, 0x8a442f99u, 0x5c37b000u, 0xb9b44d1eu,
     0x05be755au, 0x9cd11bb2u, 0x8bc7b762u, 0xa5622282u, 0x8e9e6580u, 0x0a155da4u},  // 6
    {0x00000007u, 0xa33d4000u, 0x50000003u, 0xa14f8cddu, 0x1640f800u, 0xd8a7af4eu,
     0x06b388e9u, 0xb6f3f5a5u, 0xf869009du, 0x6b9d2842u, 0xa663766bu, 0x0bc397eau},  // 7
    {0x00000008u, 0x28460000u, 0x80000004u, 0xb85aea21u, 0xd04a4000u, 0xf79b117du,
     0x07a89c78u, 0xd116cf98u, 0x650a49d8u, 0x31d82e03u, 0xbe288756u, 0x0d71d230u},  // 8
    {0x00000009u, 0xad4ec000u, 0xb0000004u, 0xcf664765u, 0x8a538800u, 0x168e73adu,
     0x089db008u, 0xeb39a98bu, 0xd1ab9313u, 0xf81333c3u, 0xd5ed9840u, 0x0f200c76u},  // 9
    {0x0000000au, 0x32578000u, 0xe0000005u, 0xe671a4a9u, 0x445cd000u, 0x3581d5ddu,
     0x0992c397u, 0x055c837eu, 0x3e4cdc4fu, 0xbe4e3984u, 0xedb2a92bu, 0x10ce46bcu},  // 10
    {0x0000000bu, 0xb7604000u, 0x10000005u, 0xfd7d01eeu, 0xfe661800u, 0x5475380cu,
     0x0a87d726u, 0x1f7f5d71u, 0xaaee258au, 0x84893f44u, 0x0577ba16u, 0x127c8103u},  // 11
    {0x0000000cu, 0x3c690000u, 0x40000006u, 0x14885f32u, 0xb86f6001u, 0x73689a3cu,
     0x0b7ceab5u, 0x39a23764u, 0x178f6ec5u, 0x4ac44505u, 0x1d3ccb01u, 0x142abb49u},  // 12
    {0x0000000du, 0xc171c000u, 0x70000006u, 0x2b93bc76u, 0x7278a801u, 0x925bfc6cu,
     0x0c71fe44u, 0x53c51157u, 0x8430b800u, 0x10ff4ac5u, 0x3501dbecu, 0x15d8f58fu},  // 13
    {0x0000000eu, 0x467a8000u, 0xa0000007u, 0x429f19bau, 0x2c81f001u, 0xb14f5e9cu,
     0x0d6711d3u, 0x6de7eb4au, 0xf0d2013bu, 0xd73a5085u, 0x4cc6ecd6u, 0x17872fd5u},  // 14
    {0x0000000fu, 0xcb834000u, 0xd0000007u, 0x59aa76feu, 0xe68b3801u, 0xd042c0cbu,
     0x0e5c2562u, 0x880ac53du, 0x5d734a76u, 0x9d755646u, 0x648bfdc1u, 0x19356a1bu},  // 15
    {0x00000010u, 0x508c0000u, 0x00000008u, 0x70b5d443u, 0xa0948001u, 0xef3622fbu,
     0x0f5138f1u, 0xa22d9f30u, 0xca1493b1u, 0x63b05c06u, 0x7c510eacu, 0x1ae3a461u},  // 16
    {0x00000011u, 0xd594c000u, 0x30000008u, 0x87c13187u, 0x5a9dc801u, 0x0e29852bu,
     0x10464c81u, 0xbc507923u, 0x36b5dcecu, 0x29eb61c7u, 0x94161f97u, 0x1c91dea7u},  // 17
    {0x00000012u, 0x5a9d8000u, 0x60000009u, 0x9ecc8ecbu, 0x14a71001u, 0x2d1ce75bu,
     0x113b6010u, 0xd6735316u, 0xa3572627u, 0xf0266787u, 0xabdb3081u, 0x1e4018edu},  // 18
    {0x00000013u, 0xdfa64000u, 0x90000009u, 0xb5d7ec0fu, 0xceb05801u, 0x4c10498au,
     0x1230739fu, 0xf0962d09u, 0x0ff86f62u, 0xb6616d48u, 0xc3a0416cu, 0x1fee5333u},  // 19
    {0x00000014u, 0x64af0000u, 0xc000000au, 0xcce34953u, 0x88b9a001u, 0x6b03abbau,
     0x1325872eu, 0x0ab906fcu, 0x7c99b89eu, 0x7c9c7308u, 0xdb655257u, 0x219c8d79u},  // 20
    {0x00000015u, 0xe9b7c000u, 0xf000000au, 0xe3eea697u, 0x42c2e801u, 0x89f70deau,
     0x141a9abdu, 0x24dbe0efu, 0xe93b01d9u, 0x42d778c8u, 0xf32a6342u, 0x234ac7bfu},  // 21
    {0x00000016u, 0x6ec08000u, 0x2000000bu, 0xfafa03dcu, 0xfccc3001u, 0xa8ea7019u,
     0x150fae4cu, 0x3efebae2u, 0x55dc4b14u, 0x09127e89u, 0x0aef742du, 0x24f90206u},  // 22
    {0x00000017u, 0xf3c94000u, 0x5000000bu, 0x12056120u, 0xb6d57802u, 0xc7ddd249u,
     0x1604c1dbu, 0x592194d5u, 0xc27d944fu, 0xcf4d8449u, 0x22b48517u, 0x26a73c4cu},  // 23
    {0x00000018u, 0x78d20000u, 0x8000000cu, 0x2910be64u, 0x70dec002u, 0xe6d13479u,
     0x16f9d56au, 0x73446ec8u, 0x2f1edd8au, 0x95888a0au, 0x3a799602u, 0x28557692u},  // 24
    {0x00000019u, 0xfddac000u, 0xb000000cu, 0x401c1ba8u, 0x2ae80802u, 0x05c496a9u,
     0x17eee8fau, 0x8d6748bbu, 0x9bc026c5u, 0x5bc38fcau, 0x523ea6edu, 0x2a03b0d8u},  // 25
    {0x0000001au, 0x82e38000u, 0xe000000du, 0x572778ecu, 0xe4f15002u, 0x24b7f8d8u,
     0x18e3fc89u, 0xa78a22aeu, 0x08617000u, 0x21fe958bu, 0x6a03b7d8u, 0x2bb1eb1eu},  // 26
    {0x0000001bu, 0x07ec4000u, 0x1000000eu, 0x6e32d631u, 0x9efa9802u, 0x43ab5b08u,
     0x19d91018u, 0xc1acfca1u, 0x7502b93bu, 0xe8399b4bu, 0x81c8c8c2u, 0x2d602564u},  // 27
    {0x0000001cu, 0x8cf50000u, 0x4000000eu, 0x853e3375u, 0x5903e002u, 0x629ebd38u,
     0x1ace23a7u, 0xdbcfd694u, 0xe1a40276u, 0xae74a10bu, 0x998dd9adu, 0x2f0e5faau},  // 28
    {0x0000001du, 0x11fdc000u, 0x7000000fu, 0x9c4990b9u, 0x130d2802u, 0x81921f68u,
     0x1bc33736u, 0xf5f2b087u, 0x4e454bb1u, 0x74afa6ccu, 0xb152ea98u, 0x30bc99f0u},  // 29
    {0x0000001eu, 0x97068000u, 0xa000000fu, 0xb354edfdu, 0xcd167002u, 0xa0858197u,
     0x1cb84ac5u, 0x10158a7au, 0xbae694edu, 0x3aeaac8cu, 0xc917fb83u, 0x326ad436u},  // 30
    {0x0000001fu, 0x1c0f4000u, 0xd0000010u, 0xca604b41u, 0x871fb802u, 0xbf78e3c7u,
     0x1dad5e54u, 0x2a38646du, 0x2787de28u, 0x0125b24du, 0xe0dd0c6eu, 0x34190e7cu},  // 31
    {0x00000020u, 0xa1180000u, 0x00000010u, 0xe16ba886u, 0x41290002u, 0xde6c45f7u,
     0x1ea271e3u, 0x445b3e60u, 0x94292763u, 0xc760b80du, 0xf8a21d58u, 0x35c748c2u},  // 32
    {0x00000021u, 0x2620c000u, 0x30000011u, 0xf87705cau, 0xfb324802u, 0xfd5fa826u,
     0x1f978572u, 0x5e7e1853u, 0x00ca709eu, 0x8d9bbdceu, 0x10672e43u, 0x37758309u},  // 33
    {0x00000022u, 0xab298000u, 0x60000011u, 0x0f82630eu, 0xb53b9003u, 0x1c530a56u,
     0x208c9902u, 0x78a0f246u, 0x6d6bb9d9u, 0x53d6c38eu, 0x282c3f2eu, 0x3923bd4fu},  // 34
    {0x00000023u, 0x30324000u, 0x90000012u, 0x268dc052u, 0x6f44d803u, 0x3b466c86u,
     0x2181ac91u, 0x92c3cc39u, 0xda0d0314u, 0x1a11c94eu, 0x3ff15019u, 0x3ad1f795u},  // 35
    {0x00000024u, 0xb53b0000u, 0xc0000012u, 0x3d991d96u, 0x294e2003u, 0x5a39ceb6u,
     0x2276c020u, 0xace6a62cu, 0x46ae4c4fu, 0xe04ccf0fu, 0x57b66103u, 0x3c8031dbu},  // 36
    {0x00000025u, 0x3a43c000u, 0xf0000013u, 0x54a47adau, 0xe3576803u, 0x792d30e5u,
     0x236bd3afu, 0xc709801fu, 0xb34f958au, 0xa687d4cfu, 0x6f7b71eeu, 0x3e2e6c21u},  // 37
    {0x00000026u, 0xbf4c8000u, 0x20000013u, 0x6bafd81fu, 0x9d60b003u, 0x98209315u,
     0x2460e73eu, 0xe12c5a12u, 0x1ff0dec5u, 0x6cc2da90u, 0x874082d9u, 0x3fdca667u},  // 38
    {0x00000027u, 0x44554000u, 0x50000014u, 0x82bb3563u, 0x5769f803u, 0xb713f545u,
     0x2555facdu, 0xfb4f3405u, 0x8c922800u, 0x32fde050u, 0x9f0593c4u, 0x418ae0adu},  // 39
    {0x00000028u, 0xc95e0000u, 0x80000014u, 0x99c692a7u, 0x11734003u, 0xd6075775u,
     0x264b0e5cu, 0x15720df8u, 0xf933713cu, 0xf938e610u, 0xb6caa4aeu, 0x43391af3u},  // 40
    {0x00000029u, 0x4e66c000u, 0xb0000015u, 0xb0d1efebu, 0xcb7c8803u, 0xf4fab9a4u,
     0x274021ebu, 0x2f94e7ebu, 0x65d4ba77u, 0xbf73ebd1u, 0xce8fb599u, 0x44e75539u},  // 41
    {0x0000002au, 0xd36f8000u, 0xe0000015u, 0xc7dd4d2fu, 0x8585d003u, 0x13ee1bd4u,
     0x2835357bu, 0x49b7c1deu, 0xd27603b2u, 0x85aef191u, 0xe654c684u, 0x46958f7fu},  // 42
    {0x0000002bu, 0x58784000u, 0x10000016u, 0xdee8aa74u, 0x3f8f1803u, 0x32e17e04u,
     0x292a490au, 0x63da9bd1u, 0x3f174cedu, 0x4be9f752u, 0xfe19d76fu, 0x4843c9c5u},  // 43
    {0x0000002cu, 0xdd810000u, 0x40000016u, 0xf5f407b8u, 0xf9986003u, 0x51d4e033u,
     0x2a1f5c99u, 0x7dfd75c4u, 0xabb89628u, 0x1224fd12u, 0x15dee85au, 0x49f2040cu},  // 44
    {0x0000002du, 0x6289c000u, 0x70000017u, 0x0cff64fcu, 0xb3a1a804u, 0x70c84263u,
     0x2b147028u, 0x98204fb7u, 0x1859df63u, 0xd86002d3u, 0x2da3f944u, 0x4ba03e52u},  // 45
    {0x0000002eu, 0xe7928000u, 0xa0000017u, 0x240ac240u, 0x6daaf004u, 0x8fbba493u,
     0x2c0983b7u, 0xb24329aau, 0x84fb289eu, 0x9e9b0893u, 0x45690a2fu, 0x4d4e7898u},  // 46
    {0x0000002fu, 0x6c9b4000u, 0xd0000018u, 0x3b161f84u, 0x27b43804u, 0xaeaf06c3u,
     0x2cfe9746u, 0xcc66039du, 0xf19c71d9u, 0x64d60e53u, 0x5d2e1b1au, 0x4efcb2deu},  // 47
    {0x00000030u, 0xf1a40000u, 0x00000018u, 0x52217cc9u, 0xe1bd8004u, 0xcda268f2u,
     0x2df3aad5u, 0xe688dd90u, 0x5e3dbb14u, 0x2b111414u, 0x74f32c05u, 0x50aaed24u},  // 48
    {0x00000031u, 0x76acc000u, 0x30000019u, 0x692cda0du, 0x9bc6c804u, 0xec95cb22u,
     0x2ee8be64u, 0x00abb783u, 0xcadf0450u, 0xf14c19d4u, 0x8cb83cefu, 0x5259276au},  // 49
    {0x00000032u, 0xfbb58000u, 0x60000019u, 0x80383751u, 0x55d01004u, 0x0b892d52u,
     0x2fddd1f4u, 0x1ace9176u, 0x37804d8bu, 0xb7871f95u, 0xa47d4ddau, 0x540761b0u},  // 50
    {0x00000033u, 0x80be4000u, 0x9000001au, 0x97439495u, 0x0fd95804u, 0x2a7c8f82u,
     0x30d2e583u, 0x34f16b69u, 0xa42196c6u, 0x7dc22555u, 0xbc425ec5u, 0x55b59bf6u},  // 51
    {0x00000034u, 0x05c70000u, 0xc000001bu, 0xae4ef1d9u, 0xc9e2a004u, 0x496ff1b1u,
     0x31c7f912u, 0x4f14455cu, 0x10c2e001u, 0x43fd2b16u, 0xd4076fb0u, 0x5763d63cu},  // 52
    {0x00000035u, 0x8acfc000u, 0xf000001bu, 0xc55a4f1du, 0x83ebe804u, 0x686353e1u,
     0x32bd0ca1u, 0x69371f4fu, 0x7d64293cu, 0x0a3830d6u, 0xebcc809bu, 0x59121082u},  // 53
    {0x00000036u, 0x0fd88000u, 0x2000001cu, 0xdc65ac62u, 0x3df53004u, 0x8756b611u,
     0x33b22030u, 0x8359f942u, 0xea057277u, 0xd0733696u, 0x03919185u, 0x5ac04ac9u},  // 54
    {0x00000037u, 0x94e14000u, 0x5000001cu, 0xf37109a6u, 0xf7fe7804u, 0xa64a1840u,
     0x34a733bfu, 0x9d7cd335u, 0x56a6bbb2u, 0x96ae3c57u, 0x1b56a270u, 0x5c6e850fu},  // 55
    {0x00000038u, 0x19ea0000u, 0x8000001du, 0x0a7c66eau, 0xb207c005u, 0xc53d7a70u,
     0x359c474eu, 0xb79fad28u, 0xc34804edu, 0x5ce94217u, 0x331bb35bu, 0x5e1cbf55u},  // 56
    {0x00000039u, 0x9ef2c000u, 0xb000001du, 0x2187c42eu, 0x6c110805u, 0xe430dca0u,
     0x36915addu, 0xd1c2871bu, 0x2fe94e28u, 0x232447d8u, 0x4ae0c446u, 0x5fcaf99bu},  // 57
    {0x0000003au, 0x23fb8000u, 0xe000001eu, 0x38932172u, 0x261a5005u, 0x03243ed0u,
     0x37866e6du, 0xebe5610eu, 0x9c8a9763u, 0xe95f4d98u, 0x62a5d530u, 0x617933e1u},  // 58
    {0x0000003bu, 0xa9044000u, 0x1000001eu, 0x4f9e7eb7u, 0xe0239805u, 0x2217a0ffu,
     0x387b81fcu, 0x06083b01u, 0x092be09fu, 0xaf9a5359u, 0x7a6ae61bu, 0x63276e27u},  // 59
    {0x0000003cu, 0x2e0d0000u, 0x4000001fu, 0x66a9dbfbu, 0x9a2ce005u, 0x410b032fu,
     0x3970958bu, 0x202b14f4u, 0x75cd29dau, 0x75d55919u, 0x922ff706u, 0x64d5a86du},  // 60
    {0x0000003du, 0xb315c000u, 0x7000001fu, 0x7db5393fu, 0x54362805u, 0x5ffe655fu,
     0x3a65a91au, 0x3a4deee7u, 0xe26e7315u, 0x3c105ed9u, 0xa9f507f1u, 0x6683e2b3u},  // 61
    {0x0000003eu, 0x381e8000u, 0xa0000020u, 0x94c09683u, 0x0e3f7005u, 0x7ef1c78fu,
     0x3b5abca9u, 0x5470c8dau, 0x4f0fbc50u, 0x024b649au, 0xc1ba18dcu, 0x68321cf9u},  // 62
    {0x0000003fu, 0xbd274000u, 0xd0000020u, 0xabcbf3c7u, 0xc848b805u, 0x9de529beu,
     0x3c4fd038u, 0x6e93a2cdu, 0xbbb1058bu, 0xc8866a5au, 0xd97f29c6u, 0x69e0573fu},  // 63
    {0x00000040u, 0x42300000u, 0x00000021u, 0xc2d7510cu, 0x82520005u, 0xbcd88beeu,
     0x3d44e3c7u, 0x88b67cc0u, 0x28524ec6u, 0x8ec1701bu, 0xf1443ab1u, 0x6b8e9185u},  // 64
    {0x00000041u, 0xc738c000u, 0x30000021u, 0xd9e2ae50u, 0x3c5b4805u, 0xdbcbee1eu,
     0x3e39f756u, 0xa2d956b3u, 0x94f39801u, 0x54fc75dbu, 0x09094b9cu, 0x6d3ccbccu},  // 65
    {0x00000042u, 0x4c418000u, 0x60000022u, 0xf0ee0b94u, 0xf6649005u, 0xfabf504du,
     0x3f2f0ae5u, 0xbcfc30a6u, 0x0194e13cu, 0x1b377b9cu, 0x20ce5c87u, 0x6eeb0612u},  // 66
    {0x00000043u, 0xd14a4000u, 0x90000022u, 0x07f968d8u, 0xb06dd806u, 0x19b2b27du,
     0x40241e75u, 0xd71f0a99u, 0x6e362a77u, 0xe172815cu, 0x38936d71u, 0x70994058u},  // 67
    {0x00000044u, 0x56530000u, 0xc0000023u, 0x1f04c61cu, 0x6a772006u, 0x38a614adu,
     0x41193204u, 0xf141e48cu, 0xdad773b2u, 0xa7ad871cu, 0x50587e5cu, 0x72477a9eu},  // 68
    {0x00000045u, 0xdb5bc000u, 0xf0000023u, 0x36102360u, 0x24806806u, 0x579976ddu,
     0x420e4593u, 0x0b64be7fu, 0x4778bceeu, 0x6de88cddu, 0x681d8f47u, 0x73f5b4e4u},  // 69
    {0x00000046u, 0x60648000u, 0x20000024u, 0x4d1b80a5u, 0xde89b006u, 0x768cd90cu,
     0x43035922u, 0x25879872u, 0xb41a0629u, 0x3423929du, 0x7fe2a032u, 0x75a3ef2au},  // 70
    {0x00000047u, 0xe56d4000u, 0x50000024u, 0x6426dde9u, 0x9892f806u, 0x95803b3cu,
     0x43f86cb1u, 0x3faa7265u, 0x20bb4f64u, 0xfa5e985eu, 0x97a7b11cu, 0x77522970u},  // 71
    {0x00000048u, 0x6a760000u, 0x80000025u, 0x7b323b2du, 0x529c4006u, 0xb4739d6cu,
     0x44ed8040u, 0x59cd4c58u, 0x8d5c989fu, 0xc0999e1eu, 0xaf6cc207u, 0x790063b6u},  // 72
    {0x00000049u, 0xef7ec000u, 0xb0000025u, 0x923d9871u, 0x0ca58806u, 0xd366ff9cu,
     0x45e293cfu, 0x73f0264bu, 0xf9fde1dau, 0x86d4a3deu, 0xc731d2f2u, 0x7aae9dfcu},  // 73
    {0x0000004au, 0x74878000u, 0xe0000026u, 0xa948f5b5u, 0xc6aed006u, 0xf25a61cbu,
     0x46d7a75eu, 0x8e13003eu, 0x669f2b15u, 0x4d0fa99fu, 0xdef6e3ddu, 0x7c5cd842u},  // 74
    {0x0000004bu, 0xf9904000u, 0x10000026u, 0xc05452fau, 0x80b81806u, 0x114dc3fbu,
     0x47ccbaeeu, 0xa835da31u, 0xd3407450u, 0x134aaf5fu, 0xf6bbf4c8u, 0x7e0b1288u},  // 75
    {0x0000004cu, 0x7e990000u, 0x40000027u, 0xd75fb03eu, 0x3ac16006u, 0x3041262bu,
     0x48c1ce7du, 0xc258b424u, 0x3fe1bd8bu, 0xd985b520u, 0x0e8105b2u, 0x7fb94ccfu},  // 76
};

FP_CONSTEXPR int lz_max(int a, int b) { return a > b ? a : b; }

// An Fq element below K p, as 12 words.
template <int K>
struct LFq {
  static_assert(K >= 1 && K <= FQ_R_OVER_P, "lazy Fq: a bound k needs k p < 2^384");
  static constexpr int k = K;
  u32 v[FQN];
};

// The words w as a value below K p (the caller vouches for the bound).
template <int K>
FP_FN LFq<K> lz_of(const u32* w) {
  LFq<K> r;
  fp_copy<Fq>(r.v, w);
  return r;
}

// The same words under the larger bound T.
template <int T, int K>
FP_FN LFq<T> lz_relax(const LFq<K>& a) {
  static_assert(K <= T, "lz_relax: only to a larger bound");
  return lz_of<T>(a.v);
}

template <int KA, int KB>
FP_FN LFq<KA + KB> lz_add(const LFq<KA>& a, const LFq<KB>& b) {
  LFq<KA + KB> r;  // below (ka + kb) p < R: nothing carries out
  u64 c = 0;
  FP_UNROLL
  for (int i = 0; i < FQN; i++) {
    c += (u64)a.v[i] + b.v[i];
    r.v[i] = (u32)c;
    c >>= 32;
  }
  return r;
}

// a - b + k_b p in one ripple: a + k_b p + ~b + 1, the carry out of the top
// word dropped (the value is below (ka + kb) p < R).
template <int KA, int KB>
FP_FN LFq<KA + KB> lz_sub(const LFq<KA>& a, const LFq<KB>& b) {
  static_assert(KB <= FQ_KP_MAX, "lz_sub: no m p row for this bound");
  LFq<KA + KB> r;
  u64 c = 1;
  FP_UNROLL
  for (int i = 0; i < FQN; i++) {
    c += (u64)a.v[i] + FQ_KP[KB][i] + (u32)~b.v[i];
    r.v[i] = (u32)c;
    c >>= 32;
  }
  return r;
}

// c a for a small constant c, one scaled ripple.
template <int C, int K>
FP_FN LFq<C * K> lz_smul(const LFq<K>& a) {
  static_assert(C >= 1 && C <= 15, "lz_smul: small constants only");
  LFq<C * K> r;
  u64 c = 0;
  FP_UNROLL
  for (int i = 0; i < FQN; i++) {
    c += (u64)a.v[i] * C;
    r.v[i] = (u32)c;
    c >>= 32;
  }
  return r;
}

template <int KA, int KB>
FP_FN LFq<lz_max(KA, KB)> lz_select(bool c, const LFq<KA>& a, const LFq<KB>& b) {
  LFq<lz_max(KA, KB)> r;
  fp_select<Fq>(r.v, c, a.v, b.v);
  return r;
}

// Below K p -> below M p, for K / 2 <= M < K: subtract M p where the value
// reaches it (compute and select).
template <int M, int K>
FP_FN LFq<M> lz_sub_mp(const LFq<K>& a) {
  static_assert(2 * M >= K && M < K && M <= FQ_KP_MAX, "lz_sub_mp: M must be in [K/2, K)");
  LFq<M> r;
  fp_cond_sub<Fq>(r.v, a.v, 0, FQ_KP[M]);
  return r;
}

// `reduce_to`: while k > T, subtract max(ceil(k/2), T) p where reached.
template <int T, int K>
FP_FN auto lz_reduce_to(const LFq<K>& a) {
  if constexpr (K <= T)
    return a;
  else
    return lz_reduce_to<T>(lz_sub_mp<lz_max((K + 1) / 2, T)>(a));
}

// `clamp`: exactly bound T (reduce if above, relabel if below).
template <int T, int K>
FP_FN LFq<T> lz_clamp(const LFq<K>& a) {
  return lz_relax<T>(lz_reduce_to<T>(a));
}

// `finalize`: canonical (< p).
template <int K>
FP_FN LFq<1> lz_finalize(const LFq<K>& a) {
  return lz_reduce_to<1>(a);
}

// THE choke point of the lazy product (`_cap_ok` / `_reduce_once` of
// pallas_curve.py:165-175): x below KX p and y below KY p, in place, the
// larger bound halved (k -> ceil(k/2): subtract ceil(k/2) p where reached)
// until KX KY p <= R.  The plan is the operands' static bounds', so the
// halvings unroll at compile time (a loop over the bounds as values, which
// the compiler cannot count, stayed a loop and cost the G2 mixed bucket 12%
// on the H100) and never branch on a value.  Every operand pair of
// fp_mul_lazy comes through here.
template <int KX, int KY>
FP_FN void lz_cap(u32* x, u32* y) {
  if constexpr (KX * KY > FQ_R_OVER_P) {
    if constexpr (KX >= KY) {
      fp_cond_sub<Fq>(x, x, 0, FQ_KP[(KX + 1) / 2]);
      lz_cap<(KX + 1) / 2, KY>(x, y);
    } else {
      fp_cond_sub<Fq>(y, y, 0, FQ_KP[(KY + 1) / 2]);
      lz_cap<KX, (KY + 1) / 2>(x, y);
    }
  }
}

// r = a b R^-1, below 2p.
template <int KA, int KB>
FP_FN void lz_mul_to(LFq<2>& r, const LFq<KA>& a, const LFq<KB>& b) {
  u32 x[FQN], y[FQN];
  fp_copy<Fq>(x, a.v);
  fp_copy<Fq>(y, b.v);
  lz_cap<KA, KB>(x, y);
  fp_mul_lazy<Fq>(r.v, x, y);
}

// ---------------------------------------------------------------------------
// Fq2 = Fq[u] / (u^2 + 5), each component with its own bound
// ---------------------------------------------------------------------------

template <int K0, int K1>
struct LFq2 {
  LFq<K0> c0;
  LFq<K1> c1;
};

template <int A0, int A1, int B0, int B1>
FP_FN LFq2<A0 + B0, A1 + B1> lz2_add(const LFq2<A0, A1>& a, const LFq2<B0, B1>& b) {
  return {lz_add(a.c0, b.c0), lz_add(a.c1, b.c1)};
}

template <int A0, int A1, int B0, int B1>
FP_FN LFq2<A0 + B0, A1 + B1> lz2_sub(const LFq2<A0, A1>& a, const LFq2<B0, B1>& b) {
  return {lz_sub(a.c0, b.c0), lz_sub(a.c1, b.c1)};
}

template <int C, int K0, int K1>
FP_FN LFq2<C * K0, C * K1> lz2_smul(const LFq2<K0, K1>& a) {
  return {lz_smul<C>(a.c0), lz_smul<C>(a.c1)};
}

template <int A0, int A1, int B0, int B1>
FP_FN LFq2<lz_max(A0, B0), lz_max(A1, B1)> lz2_select(bool c, const LFq2<A0, A1>& a,
                                                      const LFq2<B0, B1>& b) {
  return {lz_select(c, a.c0, b.c0), lz_select(c, a.c1, b.c1)};
}

template <int T, int K0, int K1>
FP_FN LFq2<T, T> lz2_relax(const LFq2<K0, K1>& a) {
  return {lz_relax<T>(a.c0), lz_relax<T>(a.c1)};
}

template <int T, int K0, int K1>
FP_FN LFq2<T, T> lz2_clamp(const LFq2<K0, K1>& a) {
  return {lz_clamp<T>(a.c0), lz_clamp<T>(a.c1)};
}

template <int K0, int K1>
FP_FN LFq2<1, 1> lz2_finalize(const LFq2<K0, K1>& a) {
  return {lz_finalize(a.c0), lz_finalize(a.c1)};
}

// The three lazy products of Karatsuba and their combination, on the
// operands lz2_mul_to (its only caller) held to the cap: t0 = a0 b0, t1 = a1
// b1, s = (a0 + a1)(b0 + b1); c1 = s - t0 - t1 (k 6), c0 = t0 - 5 t1 (k 12),
// both reduced to 4 (`_RowOpsFq2.mul_many`, pallas_curve.py:273-299).  A real
// call, as fp2_mul, and the NOTE at fp_mul holds here too.
FP_CALL_FN void lz2_mul_core(LFq2<4, 4>& r, const u32* a0, const u32* b0, const u32* a1,
                             const u32* b1, const u32* sa, const u32* sb) {
  LFq<2> t0, t1, s;
  fp_mul_lazy<Fq>(t0.v, a0, b0);
  fp_mul_lazy<Fq>(t1.v, a1, b1);
  fp_mul_lazy<Fq>(s.v, sa, sb);
  r.c1 = lz_reduce_to<4>(lz_sub(lz_sub(s, t0), t1));
  r.c0 = lz_reduce_to<4>(lz_sub(t0, lz_smul<5>(t1)));
}

// r = a b.  The operands' halvings (the choke point at the components'
// static bounds) and the Karatsuba sums run inline, the products in the
// call.  (Taking the halvings and sums into the call, one copy for every
// bound combination or one copy with the bounds as values, ran the G2 mixed
// bucket kernel 24% / 17% slower on the H100: PERF.md.)
template <int A0, int A1, int B0, int B1>
FP_FN void lz2_mul_to(LFq2<4, 4>& r, const LFq2<A0, A1>& a, const LFq2<B0, B1>& b) {
  u32 x0[FQN], y0[FQN], x1[FQN], y1[FQN], xs[FQN], ys[FQN];
  fp_copy<Fq>(x0, a.c0.v);
  fp_copy<Fq>(y0, b.c0.v);
  lz_cap<A0, B0>(x0, y0);
  fp_copy<Fq>(x1, a.c1.v);
  fp_copy<Fq>(y1, b.c1.v);
  lz_cap<A1, B1>(x1, y1);
  const auto sa = lz_add(a.c0, a.c1);
  const auto sb = lz_add(b.c0, b.c1);
  fp_copy<Fq>(xs, sa.v);
  fp_copy<Fq>(ys, sb.v);
  lz_cap<A0 + A1, B0 + B1>(xs, ys);
  lz2_mul_core(r, x0, y0, x1, y1, xs, ys);
}

// b3 a = (3 a1, k a0), k = FQ_B3K (pallas_curve.py:303-315): note which slot
// each lands in.
template <int K0, int K1>
FP_FN LFq2<3 * K1, 2> lz2_mul_b3(const LFq2<K0, K1>& a) {
  LFq2<3 * K1, 2> r;
  r.c0 = lz_smul<3>(a.c1);
  lz_mul_to(r.c1, a.c0, lz_of<1>(FQ_B3K));
  return r;
}
