"""On-chain verifier artifact: render a self-contained Solidity Groth16
verifier contract from a gnark-format verifying key.

Reference analog: the embedded contracts under
crates/recursion/gnark-ffi/assets/ (IZKMVerifier.sol + Groth16Verifier);
this generator produces an equivalent contract from scratch — the vk's
curve points are baked in as constants and verification uses the BN254
precompiles (0x06 ecAdd, 0x07 ecMul, 0x08 ecPairing).

Contract semantics mirror ``gnark.verify_gnark_groth16``:

  verifyProof(bytes proof, bytes32 zkmVkeyHash, bytes publicValues)

  * proof[0:4] must equal the first 4 bytes of sha256(vk bytes)
  * public input 0 = uint256(zkmVkeyHash) with the top byte dropped
  * public input 1 = sha256(publicValues) masked to 253 bits
  * pairing check e(-A,B) * e(acc,gamma) * e(C,delta) * e(alpha,beta) == 1

No solc ships in this build environment, so the emitted source is pinned by
tests (constants re-parsed and compared to the vk) rather than compiled.
"""

from __future__ import annotations

import hashlib

from .gnark import GnarkGroth16Vk, load_groth16_vk

_TEMPLATE = """\
// SPDX-License-Identifier: MIT
// Auto-generated by zkmips_tpu.verifier.solidity — do not edit.
pragma solidity ^0.8.20;

/// @notice Groth16 verifier for zkMIPS-TPU proofs over BN254.
/// @dev vk hash (sha256 of the gnark vk bytes): 0x{vk_hash}
contract ZKMVerifier {{
    uint256 private constant P = 21888242871839275222246405745257275088696311157297823662689037894645226208583;
    uint256 private constant R = 21888242871839275222246405745257275088548364400416034343698204186575808495617;

    bytes4 public constant VERIFIER_HASH = 0x{vk_hash4};

    // vk.alpha (G1)
    uint256 private constant ALPHA_X = {alpha_x};
    uint256 private constant ALPHA_Y = {alpha_y};
    // vk.beta (G2), EIP-197 layout: imaginary limb first
    uint256 private constant BETA_X1 = {beta_x1};
    uint256 private constant BETA_X0 = {beta_x0};
    uint256 private constant BETA_Y1 = {beta_y1};
    uint256 private constant BETA_Y0 = {beta_y0};
    // vk.gamma (G2)
    uint256 private constant GAMMA_X1 = {gamma_x1};
    uint256 private constant GAMMA_X0 = {gamma_x0};
    uint256 private constant GAMMA_Y1 = {gamma_y1};
    uint256 private constant GAMMA_Y0 = {gamma_y0};
    // vk.delta (G2)
    uint256 private constant DELTA_X1 = {delta_x1};
    uint256 private constant DELTA_X0 = {delta_x0};
    uint256 private constant DELTA_Y1 = {delta_y1};
    uint256 private constant DELTA_Y0 = {delta_y0};
    // vk.K input commitments (G1): K0 + vkeyHash*K1 + pvDigest*K2
{k_constants}

    error InvalidProof();
    error WrongVerifierHash();

    /// @param proofBytes 4-byte vk-hash prefix || 256-byte uncompressed proof (A,B,C)
    /// @param zkmVkeyHash the guest program's vkey hash (Poseidon2 root, bytes32)
    /// @param publicValues the committed public-values stream
    function verifyProof(
        bytes calldata proofBytes,
        bytes32 zkmVkeyHash,
        bytes calldata publicValues
    ) external view {{
        if (bytes4(proofBytes[:4]) != VERIFIER_HASH) revert WrongVerifierHash();
        uint256 input0 = uint256(zkmVkeyHash) & ((1 << 248) - 1); // drop top byte
        uint256 input1 = uint256(sha256(publicValues)) & ((1 << 253) - 1);

        uint256 aX = uint256(bytes32(proofBytes[4:36]));
        uint256 aY = uint256(bytes32(proofBytes[36:68]));
        uint256 bX1 = uint256(bytes32(proofBytes[68:100]));
        uint256 bX0 = uint256(bytes32(proofBytes[100:132]));
        uint256 bY1 = uint256(bytes32(proofBytes[132:164]));
        uint256 bY0 = uint256(bytes32(proofBytes[164:196]));
        uint256 cX = uint256(bytes32(proofBytes[196:228]));
        uint256 cY = uint256(bytes32(proofBytes[228:260]));

        // acc = K0 + input0*K1 + input1*K2
        (uint256 accX, uint256 accY) = _g1Add(K0_X, K0_Y, _g1Mul(K1_X, K1_Y, input0));
        (accX, accY) = _g1Add(accX, accY, _g1Mul(K2_X, K2_Y, input1));

        // e(-A, B) * e(acc, gamma) * e(C, delta) * e(alpha, beta) == 1
        uint256[24] memory pairs;
        pairs[0] = aX; pairs[1] = aY == 0 ? 0 : P - aY;
        pairs[2] = bX1; pairs[3] = bX0; pairs[4] = bY1; pairs[5] = bY0;
        pairs[6] = accX; pairs[7] = accY;
        pairs[8] = GAMMA_X1; pairs[9] = GAMMA_X0; pairs[10] = GAMMA_Y1; pairs[11] = GAMMA_Y0;
        pairs[12] = cX; pairs[13] = cY;
        pairs[14] = DELTA_X1; pairs[15] = DELTA_X0; pairs[16] = DELTA_Y1; pairs[17] = DELTA_Y0;
        pairs[18] = ALPHA_X; pairs[19] = ALPHA_Y;
        pairs[20] = BETA_X1; pairs[21] = BETA_X0; pairs[22] = BETA_Y1; pairs[23] = BETA_Y0;
        uint256[1] memory out;
        bool ok;
        assembly {{
            ok := staticcall(gas(), 0x08, pairs, 768, out, 32)
        }}
        if (!ok || out[0] != 1) revert InvalidProof();
    }}

    function _g1Add(uint256 x1, uint256 y1, uint256[2] memory q)
        private view returns (uint256, uint256)
    {{
        uint256[4] memory input = [x1, y1, q[0], q[1]];
        uint256[2] memory result;
        bool ok;
        assembly {{
            ok := staticcall(gas(), 0x06, input, 128, result, 64)
        }}
        require(ok, "ecAdd failed");
        return (result[0], result[1]);
    }}

    function _g1Mul(uint256 x, uint256 y, uint256 s)
        private view returns (uint256[2] memory result)
    {{
        uint256[3] memory input = [x, y, s % R];
        bool ok;
        assembly {{
            ok := staticcall(gas(), 0x07, input, 96, result, 64)
        }}
        require(ok, "ecMul failed");
    }}
}}
"""


def render_groth16_verifier(vk_bytes: bytes) -> str:
    """Render the Solidity verifier source for a gnark-format Groth16 vk."""
    vk: GnarkGroth16Vk = load_groth16_vk(vk_bytes)
    if len(vk.k) != 3:
        raise ValueError("contract is specialized to 2 public inputs (vkey hash + pv digest)")

    def g2(pt):
        (x0, x1), (y0, y1) = pt
        return {"x1": x1, "x0": x0, "y1": y1, "y0": y0}

    b, g, d = g2(vk.beta), g2(vk.gamma), g2(vk.delta)
    k_lines = []
    for i, (kx, ky) in enumerate(vk.k):
        k_lines.append(f"    uint256 private constant K{i}_X = {kx};")
        k_lines.append(f"    uint256 private constant K{i}_Y = {ky};")
    return _TEMPLATE.format(
        vk_hash=hashlib.sha256(vk_bytes).hexdigest(),
        vk_hash4=hashlib.sha256(vk_bytes).digest()[:4].hex(),
        alpha_x=vk.alpha[0], alpha_y=vk.alpha[1],
        beta_x1=b["x1"], beta_x0=b["x0"], beta_y1=b["y1"], beta_y0=b["y0"],
        gamma_x1=g["x1"], gamma_x0=g["x0"], gamma_y1=g["y1"], gamma_y0=g["y0"],
        delta_x1=d["x1"], delta_x0=d["x0"], delta_y1=d["y1"], delta_y0=d["y0"],
        k_constants="\n".join(k_lines),
    )
